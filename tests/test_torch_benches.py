"""PyTorch port, the benches and their measurement on the CPU: each
``irsde::`` operator's FLOP formula against its closed form,
``FlopCounterMode`` over small nets counting the operators' FLOPs, the
card-keyed peaks, the step timer, MFU; ``bench_train``, ``bench_refusion``
and ``count_flops`` with ``--device cpu`` at tiny sizes, each printing its
JSON line (or lines) with the JAX benches' keys."""

import json
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from image_restoration_sde_tpu_torch import bench_refusion, bench_train, count_flops
from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, ConditionalUNet, init_params_
from image_restoration_sde_tpu_torch.models.dit import DiT
from image_restoration_sde_tpu_torch.ops import flash_attention, layernorm, linear_attention, naf_stack
from image_restoration_sde_tpu_torch.utils import profiling

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this module: the suite runs several workers on
    the machine's cores, where many threads a worker spin on the full-width
    nets' small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the JAX benches' keys (tools/bench_train.py, tools/bench_refusion.py)
TRAIN_KEYS = {"metric", "value", "unit", "mfu", "step_ms"}
REFUSION_KEYS = {"metric", "value", "unit", "sec_per_image", "rep_spread"}


def _closed_form(name, shapes, args):
    """The work of one call from its shapes, written out: K1 8 FLOP an
    element; K2a and K2b each 2 B N h d^2 + 4 B N h d; K3 per block B H W
    (12 C^2 + 66 C) + 2 B C^2; K4 4 B H Nq Nk D; K5 4 BH N d^2."""
    if name == "channel_layernorm":
        return 8 * math.prod(shapes[0])
    if name == "linear_attention_packed":
        (B, N, _), (h, d) = shapes[0], args
        return 2 * (2 * B * N * h * d * d + 4 * B * N * h * d)
    if name == "naf_stack":
        B, H, W, C = shapes[0]
        K = len(shapes[2]) // len(naf_stack.PARAM_ORDER)
        return K * (B * H * W * (12 * C * C + 66 * C) + 2 * B * C * C)
    if name == "flash_mha":
        B, Nq, H, D = shapes[0]
        return 4 * B * H * Nq * shapes[1][1] * D
    if name == "linear_attention":
        BH, N, d = shapes[0]
        return 4 * BH * N * d * d
    raise KeyError(name)


class OpCalls(TorchDispatchMode):
    """Records each ``irsde::`` call: (name, input shapes, int arguments)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "irsde":
            shapes = [list(a.shape) if isinstance(a, torch.Tensor) else [t.shape for t in a]
                      for a in args if isinstance(a, (torch.Tensor, list))]
            self.calls.append((func._opname, shapes, [a for a in args if isinstance(a, int)]))
        return func(*args, **(kwargs or {}))


def _counted(fn):
    """({op name: FLOPs} FlopCounterMode counted for the irsde operators,
    {op name: the closed forms summed over the calls})."""
    with FlopCounterMode(display=False) as counter, OpCalls() as calls:
        fn()
    got = {str(op).split(".")[-1]: n for op, n in counter.get_flop_counts()["Global"].items()
           if str(op).startswith("irsde.")}
    want = {}
    for name, shapes, ints in calls.calls:
        want[name] = want.get(name, 0) + _closed_form(name, shapes, ints)
    return got, want


def _blocks(K, C, gen):
    return [{k: torch.randn(v, generator=gen) * 0.1 for k, v in (
        ("conv1.weight", (2 * C, C, 1, 1)), ("conv1.bias", (2 * C,)), ("conv2.weight", (2 * C, 1, 3, 3)),
        ("conv2.bias", (2 * C,)), ("sca.1.weight", (C, C, 1, 1)), ("sca.1.bias", (C,)),
        ("conv3.weight", (C, C, 1, 1)), ("conv3.bias", (C,)), ("conv4.weight", (2 * C, C, 1, 1)),
        ("conv4.bias", (2 * C,)), ("conv5.weight", (C, C, 1, 1)), ("conv5.bias", (C,)), ("norm1.g", (1, C, 1, 1)),
        ("norm2.g", (1, C, 1, 1)), ("beta", (1, C, 1, 1)), ("gamma", (1, C, 1, 1)),
        ("mlp.1.weight", (4 * C, 8)), ("mlp.1.bias", (4 * C,)))} for _ in range(K)]


OP_CALLS = {
    "channel_layernorm": lambda g: layernorm.channel_layernorm(torch.randn(2, 5, 7, 32, generator=g),
                                                               torch.ones(32)),
    "linear_attention_packed": lambda g: linear_attention.linear_attention_packed(
        torch.randn(2, 12, 384, generator=g), 4, 32),
    "naf_stack": lambda g: naf_stack.naf_stack(torch.randn(1, 4, 4, 16, generator=g), _blocks(3, 16, g),
                                               torch.randn(1, 16, generator=g)),
    "flash_mha": lambda g: flash_attention.flash_mha(torch.randn(1, 10, 2, 64, generator=g),
                                                     *torch.randn(2, 1, 12, 2, 64, generator=g), 0.125),
    "linear_attention": lambda g: linear_attention.linear_attention(*torch.randn(3, 3, 20, 16, generator=g)),
}


@pytest.mark.parametrize("name", sorted(OP_CALLS))
def test_flop_formula_is_the_closed_form(name):
    """One call of each operator on the CPU: FlopCounterMode counts its
    registered formula, which equals the closed form of its shapes."""
    got, want = _counted(lambda: OP_CALLS[name](torch.Generator().manual_seed(0)))
    assert set(got) == {name} and got == want and got[name] > 0


NETS = {
    "unet": (lambda: ConditionalUNet(nf=8, depth=2), 3, 16),  # K1, K2
    "nafnet": (lambda: ConditionalNAFNet(img_channel=3, width=8, enc_blk_nums=(1, 4), middle_blk_num=1,
                                         dec_blk_nums=(1, 1)), 3, 16),  # K1, K3
    "dit": (lambda: DiT(patch_size=2, in_channels=4, hidden_size=128, depth=2, num_heads=2), 4, 8),  # K4
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_flop_counter_counts_the_operators_in_a_net(net):
    """A forward and backward of a small net under FlopCounterMode: each
    operator it calls counted at the closed form of every call's shapes
    (the operators' backwards are plain compositions, counted as such), and
    the total above the operators' alone."""
    build, ch, hw = NETS[net]
    model = init_params_(build(), torch.Generator().manual_seed(1))
    x = torch.rand(2, hw, hw, ch, generator=torch.Generator().manual_seed(2))

    def step():
        model(x, x, torch.tensor([3.0, 40.0])).sum().backward()

    got, want = _counted(step)
    assert got == want and got
    total, _ = profiling.count_flops(step)
    assert total > sum(got.values())


def test_peaks_are_the_cards_own(monkeypatch):
    """The H100's published dense peaks by its name; another card raises."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiling.peak_flops("bfloat16") == 989e12 and profiling.peak_flops("float32") == 67e12
    assert profiling.peak_flops("tf32") == 494.7e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other GPU")
    with pytest.raises(KeyError, match="no published peak"):
        profiling.peak_flops("bfloat16")


def test_step_timer_sets_the_first_call_apart_and_mfu():
    timer = profiling.StepTimer()
    assert timer.summary() == {"compile_s": 0.0}
    for _ in range(4):
        with timer.step():
            pass
    s = timer.summary()
    assert set(s) == {"compile_s", "mean_s", "p50_s", "p95_s"} and len(timer.times) == 3
    assert profiling.estimate_mfu(2e12, 0.5, 8e12) == 0.5


@pytest.mark.parametrize("arch, env", [
    ("unet", {"BENCH_BATCH": "1", "BENCH_SIZE": "16", "BENCH_STEPS": "1"}),
    ("refusion", {"BENCH_BATCH": "1", "BENCH_SIZE": "256", "BENCH_STEPS": "1"}),
], ids=["unet", "refusion"])
def test_bench_train_prints_one_line_on_the_cpu(arch, env, monkeypatch, capsys):
    """``python -m ...bench_train --device cpu`` at tiny crops (the nets at
    full width): one JSON line with the JAX bench's keys, in img/s/CPU with
    no MFU (no card), the step's FLOPs counting the operators'."""
    for k, v in {"BENCH_ARCH": arch, **env}.items():
        monkeypatch.setenv(k, v)
    bench_train.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert len(lines) == 1 and TRAIN_KEYS <= set(line) and line["unit"] == "img/s/CPU" and line["mfu"] is None
    assert line["value"] > 0 and line["step_ms"] > 0 and line["world"] == 1 and line["flops_per_step"] > 0
    assert ("UNet nf64d4" if arch == "unet" else "enc[1,1,1,28]") in line["metric"]


def test_bench_refusion_prints_one_line_on_the_cpu(monkeypatch, capsys):
    for k, v in {"BENCH_ARCH": "nafnet", "BENCH_SIZE": "64", "BENCH_STEPS": "2", "BENCH_REPS": "1"}.items():
        monkeypatch.setenv(k, v)
    bench_refusion.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert len(lines) == 1 and REFUSION_KEYS <= set(line) and line["unit"] == "img/s/CPU" and line["value"] > 0
    assert "2-step latent SDE, NAFNet w64" in line["metric"] and line["peak_gib"] is None


def test_count_flops_prints_the_score_net_and_compressor(capsys):
    """``count_flops`` on the nasde YAML at 32x32: parameters and forward
    FLOPs of the score net and the compressor, as ``count`` returns."""
    from image_restoration_sde_tpu_torch.utils import options

    yml = "configs/latent-dehazing/test/nasde.yml"
    assert count_flops.main([f"-opt={yml}", "--height", "32", "--width", "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[ConditionalNAFNet] params: " in out and "[UNet compressor] params: " in out
    opt = options.dict_to_nonedict(options.parse(yml, is_train=False))
    counted = count_flops.count(opt, 32, 32, torch.device("cpu"))
    assert all(n > 0 and f > 0 for n, f in counted.values())
    assert f"{counted['ConditionalNAFNet'][1] / 1e9:.2f} G" in out
