"""K1, the channel LayerNorm (``ops/layernorm.py`` -> ``csrc/layernorm.cu``)
on ``(rows, C)``: x read and y written once in the compute dtype, the
float32 gain read once; ~8 operations an element (mean, centred square,
scale), float32 arithmetic."""

SYMBOLS = ("irsde_channel_layernorm",)
DEVICE_NAMES = ("channel_layernorm_kernel",)
SITE = "k1"


def work(site: tuple) -> tuple:
    _, rows, C, itemsize = site
    return 2 * rows * C * itemsize + C * 4, [(8 * rows * C, "float32")]
