"""The region-table build T1's entry, ``ops/hf_tables.build_hf_tables``, on
the CPU: each form of ``lr`` it takes (a host tuple, an int32 (3,) tensor
as the device holds it, the packed (16,) frame uniforms the fused frame
program reads it from) against JAX's ``build_hf_tables``, op by op word
for word and jitted within the bounds ``test_build_hf_tables_equal`` uses,
and its ``out=`` and ``hcol=`` options against the plain functions.  The
kernel itself is held to the plain version on the card (``chip_smoke.py``
``hf_tables_kernel``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import trace_pallas as jax_tables
from raytrace_tpu_torch.ops import hf_tables
from raytrace_tpu_torch.render.pipeline import FrameUniforms

REGIONS = [(0, 0, 0), (16, 0, 0), (-48, 0, 0), (1000, 0, -1000)]
LATTICE = ("cA", "cB", "cC", "cD")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _lr_forms(lr):
    """``lr`` as the entry takes it: a host tuple, an int32 (3,) tensor and
    the packed uniforms (lr.y is always 0 there)."""
    packed = torch.from_numpy(FrameUniforms(lr=lr).packed())
    return dict(tuple=lr, tensor=torch.tensor(lr, dtype=torch.int32), packed=packed)


@pytest.fixture(scope="module", params=REGIONS, ids=str)
def jax_region(request):
    lr = jnp.asarray(request.param, jnp.int32)
    with jax.disable_jit():
        eager = jax_tables.build_hf_tables(lr, seed=0)
    jitted = jax_tables.build_hf_tables(lr, seed=0)
    flat = lambda t: {k: np.asarray(v).reshape(-1) for k, v in t.items()}
    return request.param, flat(eager), flat(jitted)


@pytest.mark.parametrize("form", ["tuple", "tensor", "packed"])
def test_tables_equal_jax(jax_region, form):
    """Every word equals JAX run op by op; against jitted JAX the pyramid
    and r0 are equal and a lattice field is at most one quantum apart."""
    lr, eager, jitted = jax_region
    got = hf_tables.build_hf_tables(_lr_forms(lr)[form], seed=0, device="cpu")
    assert set(got) == set(eager) == set(hf_tables.TABLE_KEYS) | {"r0"}
    for key in eager:
        assert got[key].dtype == torch.int32, key
        np.testing.assert_array_equal(got[key].numpy(), eager[key], err_msg=key)
        if key in LATTICE:
            for sh in (0, 16):
                d = np.abs(((got[key].numpy() >> sh) & 0xFFFF)
                           - ((jitted[key] >> sh) & 0xFFFF))
                assert d.max() <= 1, key
        else:
            np.testing.assert_array_equal(got[key].numpy(), jitted[key], err_msg=key)


def test_host_lr_reads_the_packed_uniforms_as_jax():
    """The packed form's lr is (packed[14], 0, packed[15]) truncated to
    int32, as ``_rffp_impl`` takes it."""
    packed = torch.zeros(16)
    packed[14], packed[15] = -47.9, 31.5
    assert hf_tables.host_lr(packed) == (-47, 0, 31)
    assert hf_tables.host_lr(torch.tensor([8, 0, -8], dtype=torch.int32)) == (8, 0, -8)
    assert hf_tables.host_lr((8, 0, -8)) == (8, 0, -8)


@pytest.mark.parametrize("seed", [0, 7])
def test_out_and_column_table_fill_in_place(seed):
    """``out=`` fills the given buffers (the same tensors come back) with
    what a fresh build gives, ``hcol=True`` with the column table of
    ``with_column_heights``; without ``hcol`` the table is left alone."""
    lr = (-48, 0, 16)
    want = hf_tables.with_column_heights(
        hf_tables.build_hf_tables(lr, seed=seed, device="cpu"), seed)
    out = hf_tables.empty_tables("cpu", hcol=True)
    assert {k: (v.dtype, tuple(v.shape)) for k, v in out.items()} == hf_tables.LAYOUT
    kept = dict(out)
    got = hf_tables.build_hf_tables(_lr_forms(lr)["packed"], seed=seed, out=out, hcol=True,
                                    device="cpu")
    assert got is out and all(got[k] is kept[k] for k in kept)
    assert all(torch.equal(got[k], want[k]) for k in want)
    bare = hf_tables.empty_tables("cpu")
    assert "hcol" not in bare
    hf_tables.build_hf_tables(lr, seed=seed, out=bare, device="cpu")
    assert all(torch.equal(bare[k], want[k]) for k in bare)


def test_other_devices_raise():
    """No device but the CPU (plain) and the card (T1) builds tables."""
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        hf_tables.build_hf_tables((0, 0, 0), device="meta")
