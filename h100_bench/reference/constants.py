"""[Frozen copy of ``raytrace_tpu_torch/constants.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Global framework constants.

The port's own copy of ``raytrace_tpu/constants.py`` (the reference's
compile-time constant set, src/render/constants.rs:16-33); a test holds
every public name equal to the JAX package's.  The world geometry constants
are load-bearing for every subsystem: chunk packing, streaming, and the
tracer's toroidal addressing all agree on these numbers.
"""

# --- Blue noise texture (reference: src/render/constants.rs:16-19) ---
BLUE_NOISE_WIDTH = 512
BLUE_NOISE_HEIGHT = 512
BLUE_NOISE_CHANNELS = 4
BLUE_NOISE_SIZE = BLUE_NOISE_WIDTH * BLUE_NOISE_HEIGHT * BLUE_NOISE_CHANNELS

# --- Chunk / world geometry (reference: src/render/constants.rs:21-31) ---
# The LOD that takes up an entire chunk.
MAX_CHUNK_LOD = 6
CHUNK_SIZE = 1 << MAX_CHUNK_LOD  # 64
CHUNK_VOLUME = CHUNK_SIZE**3
# Number of chunks along each axis of the resident world volume. Must be even.
ROOT_CHUNK_SIZE = 4
ROOT_BLOCK_SIZE = CHUNK_SIZE * ROOT_CHUNK_SIZE  # 256
ROOT_BLOCK_VOLUME = ROOT_BLOCK_SIZE**3
# Terrain is streamed into the device volume in slices this many voxels thick.
SLICE_SIZE = 16
SLICES_PER_CHUNK = CHUNK_SIZE // SLICE_SIZE
SLICES_PER_ROOT = ROOT_BLOCK_SIZE // SLICE_SIZE  # 16

# --- Render defaults (reference: src/render/constants.rs:9-10, raytrace.comp:57-58,109) ---
DEFAULT_WIDTH = 1024
DEFAULT_HEIGHT = 1024
# Lighting values are divided by this before being stored, giving HDR headroom
# in the float16 lighting G-buffer (reference: raytrace.comp:57).
LIGHTING_SCALE = 16.0
# Hard cap on DDA steps per ray (reference: raytrace.comp:109).
MAX_TRACE_STEPS = 2048
# Denoiser pass dilation schedule (reference: src/render/pipeline/pipeline.rs:103).
DENOISE_SIZES = (1, 2, 4, 8, 8, 16)

# Face-normal ids (reference: raytrace.comp:45-47): axis*2 for the -facing
# face, axis*2+1 for the +facing face; 16 = sky / no hit.
NORMAL_X = 0
NORMAL_Y = 2
NORMAL_Z = 4
NORMAL_SKY = 16

# --- Worldgen (reference: src/world/generate.rs:11,31-51,63) ---
WORLDGEN_SCALE = 600.0
WORLDGEN_HEIGHT_MUL = 0.2
WORLDGEN_HEIGHT_OFFSET = 10.0
WATER_TABLE_Z = 12
# Height bands for material selection: below 20 grass(2), 20-80 dither
# grass(2)->red rock(5), 80-160 dither red rock(5)->snow(6), above 160 snow.
BAND_LOW = 20
BAND_MID = 80
BAND_HIGH = 160
