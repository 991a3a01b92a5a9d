"""The region tables' key (``ops/hf_tables.build_hf_tables(..., key=)``) on
the CPU: an int32 (4,) tensor ``(lr.x, lr.y, seed, valid)`` saying what
the ``out=`` buffers hold.  A keyed build of the region and seed the key
holds does nothing; any other builds the plain tables into ``out`` and
sets the key.  The tables of every build are held to JAX's
``build_hf_tables`` of the same region word for word.  On the card T1
makes the same comparison at entry (``chip_smoke.py`` ``hf_tables_kernel``
shows the skip with a sentinel); the fused frame program's use of the key
is in ``tests/test_torch_frame_graph.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import trace_pallas as jax_tables
from raytrace_tpu_torch.ops import hf_tables
from raytrace_tpu_torch.render.pipeline import FrameUniforms

A, B = (16, 0, 0), (-48, 0, 0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_tables(lr, seed):
    with jax.disable_jit():
        tables = jax_tables.build_hf_tables(jnp.asarray(lr, jnp.int32), seed=seed)
    return {k: np.asarray(v).reshape(-1) for k, v in tables.items()}


def _counting(monkeypatch) -> list:
    """The (lr, seed) of each plain build from now on."""
    built = []
    plain = hf_tables.build_hf_tables_plain
    monkeypatch.setattr(hf_tables, "build_hf_tables_plain",
                        lambda lr, seed=0, *a: built.append((tuple(lr), seed))
                        or plain(lr, seed, *a))
    return built


@pytest.mark.parametrize("form", ["tuple", "tensor", "packed"])
def test_keyed_builds_run_exactly_on_each_change(monkeypatch, form):
    """Through one key and one set of buffers: lr A, A, B, A, then A under
    another seed, then A again after the key is made not valid.  A plain
    build runs on each change and only then; after each call the buffers
    equal JAX's tables of that region and seed word for word, the column
    table equals ``column_heights`` of them, and the key holds
    ``(lr.x, lr.y, seed, 1)``."""
    as_form = dict(tuple=lambda lr: lr,
                   tensor=lambda lr: torch.tensor(lr, dtype=torch.int32),
                   packed=lambda lr: torch.from_numpy(FrameUniforms(lr=lr).packed()))[form]
    out = hf_tables.empty_tables("cpu", hcol=True)
    key = torch.zeros(4, dtype=torch.int32)
    built = _counting(monkeypatch)
    steps = [(A, 0, True), (A, 0, False), (B, 0, True), (A, 0, True), (A, 7, True),
             (A, 7, False), ("invalid", 7, True)]
    want_built = []
    for lr, seed, builds in steps:
        if lr == "invalid":
            key[3] = 0  # another writer touched the buffers
            lr = A
        before = {k: v.clone() for k, v in out.items()}
        got = hf_tables.build_hf_tables(as_form(lr), seed, out=out, hcol=True, key=key,
                                        device="cpu")
        assert got is out
        if builds:
            want_built.append((lr, seed))
        else:
            assert all(torch.equal(out[k], before[k]) for k in out), (lr, seed)
        assert built == want_built, (lr, seed)
        theirs = _jax_tables(lr, seed)
        for k in hf_tables.TABLE_KEYS:
            assert np.array_equal(out[k].numpy(), theirs[k]), (lr, seed, k)
        assert out["r0"].tolist() == [lr[0] - 128, lr[1] - 128]
        assert torch.equal(out["hcol"], hf_tables.column_heights(out, seed))
        assert key.tolist() == [lr[0], lr[1], seed, 1]


def test_unkeyed_builds_always_run(monkeypatch):
    """Without a key every call builds, as ``Pipeline.tables()`` and the
    hf frames call it."""
    out = hf_tables.empty_tables("cpu")
    built = _counting(monkeypatch)
    for _ in range(2):
        hf_tables.build_hf_tables(A, out=out, device="cpu")
    assert built == [(A, 0), (A, 0)]


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "no_out"])
def test_a_bad_key_is_refused(bad):
    """A key must be an int32 (4,) tensor on the tables' device, beside the
    ``out`` buffers it describes; anything else raises, and nothing is
    written into ``out`` or the key."""
    out = hf_tables.empty_tables("cpu")
    before = {k: v.clone() for k, v in out.items()}
    key = dict(dtype=torch.zeros(4, dtype=torch.int64),
               shape=torch.zeros(5, dtype=torch.int32),
               device=torch.zeros(4, dtype=torch.int32, device="meta"),
               no_out=torch.zeros(4, dtype=torch.int32))[bad]
    with pytest.raises(ValueError, match="key"):
        hf_tables.build_hf_tables(A, out=None if bad == "no_out" else out, key=key, device="cpu")
    assert all(torch.equal(out[k], before[k]) for k in out)
    if bad != "device":
        assert not key.any()
