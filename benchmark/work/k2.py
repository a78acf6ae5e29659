"""K2a and K2b together, the packed linear attention of four heads of 32
(``ops/linear_attention.py`` -> ``csrc/linear_attention.cu``) on ``(B, N)``
positions: K2a reads k and v (256 channels a row) and writes the float32
context, K2b reads q (128 channels) and the context and writes the output
(128 channels); per head and row 2 x 32 x 32 operations for each of the
two products (on the tensor cores of the compute dtype) and 4 for each
exponential and sum of the two softmaxes (float32)."""

from benchmark.work import product_peak

SYMBOLS = ("irsde_la_ctx", "irsde_la_apply")
DEVICE_NAMES = ("la_ctx_kernel", "la_apply_kernel")
SITE = "k2"
HEADS, DIM_HEAD = 4, 32


def work(site: tuple) -> tuple:
    _, B, N, itemsize = site
    hidden = HEADS * DIM_HEAD
    ctx_bytes = B * HEADS * DIM_HEAD * DIM_HEAD * 4
    nbytes = B * N * 2 * hidden * itemsize + ctx_bytes + B * N * 2 * hidden * itemsize + ctx_bytes
    products = 2 * 2 * B * N * HEADS * DIM_HEAD * DIM_HEAD
    softmaxes = 2 * 4 * B * N * hidden
    return nbytes, [(products, product_peak(itemsize)), (softmaxes, "float32")]
