"""K3, the fused stack of K NAFBlocks at one level (``ops/naf_stack.py`` ->
``csrc/naf_stack.cu``) on x ``(B, H, W, C)``: each block's float32 weights
read once, x read and the output written once in the compute dtype, the
float32 time modulation (K, B, 4C) read once; per pixel and block the
four 1x1 products (12 C^2) on the tensor cores of the compute dtype, and
per sample and block the channel attention's product (2 C^2) likewise; the
depthwise 3x3 (36 C), norms, gates and residuals (~30 C) in float32."""

from benchmark.work import product_peak

SYMBOLS = ("irsde_naf_stack",)
DEVICE_NAMES = ("naf_stack_kernel",)
SITE = "k3"


def block_weights(C: int) -> int:
    """Elements of one block's tensors that K3 reads (the time Dense is
    applied outside): conv1-conv5, the depthwise kernel, SCA, norms, beta,
    gamma with their biases."""
    return (2 * C * C + 2 * C) + (18 * C + 2 * C) + (C * C + C) + (C * C + C) + (2 * C * C + 2 * C) \
        + (C * C + C) + 4 * C


def work(site: tuple) -> tuple:
    _, B, H, W, C, K, itemsize = site
    nbytes = K * block_weights(C) * 4 + 2 * B * H * W * C * itemsize + K * B * 4 * C * 4
    products = K * (B * H * W * 12 * C * C + B * 2 * C * C)
    elementwise = K * B * H * W * (36 * C + 30 * C)
    return nbytes, [(products, product_peak(itemsize)), (elementwise, "float32")]
