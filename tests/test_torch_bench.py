"""The port's measuring entry point (``python -m vidsitu_tpu_torch.bench``)
on the CPU at tiny sizes: well-formed JSON lines under the JAX bench's metric
names, the training modes not ported yet refused, the gates refused off the card, and the
analytic decode-traffic count equal to the JAX bench's (root ``bench.py``
imports JAX only inside its functions).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jax_bench
from vidsitu_tpu_torch import bench, gates
from vidsitu_tpu_torch.ops import copy_probe as CP
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

REPO = Path(__file__).resolve().parent.parent
LINE_KEYS = {"metric", "value", "unit", "device", *bench.ROOFLINE_KEYS}


def _run_bench(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "vidsitu_tpu_torch.bench", *args], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout[-2000:]
    return json.loads(lines[0])


def _check_cpu_line(res, metric):
    assert LINE_KEYS <= set(res), set(res)
    assert res["metric"] == metric
    assert res["device"] == "cpu"
    assert np.isfinite(res["value"]) and res["value"] > 0
    # a CPU time is never written under a device metric: no roofline
    assert all(res[k] is None for k in bench.ROOFLINE_KEYS)


def test_featext_prints_one_json_line_on_cpu():
    res = _run_bench("featext", "2", "1", "--device=cpu",
                     "--vid_mdl.resnet.depth=26", "--vid_mdl.crop_size=32")
    _check_cpu_line(res, "slowfast_r50_8x8_featext")
    assert res["unit"] == "clips/sec/cpu" and res["clips"] == 2
    assert res["flops_per_forward"] > 0


@pytest.mark.parametrize("mode,metric", [
    ("decode5", "srl_beam5_decode_latency"),
    ("decode", "srl_greedy_decode_latency"),
])
def test_decode_prints_one_json_line_on_cpu(mode, metric):
    res = _run_bench(mode, "2", "1", "--device=cpu", "--gen.max_len_b=10",
                     "--tx_dec.decoder_embed_dim=64",
                     "--tx_dec.encoder_embed_dim=64")
    _check_cpu_line(res, metric)
    assert res["unit"] == "ms/video" and res["bs"] == 2
    assert 1 <= res["steps"] <= 11


def test_decode_real_names_its_width_in_the_metric():
    res = bench.main(["decode5_real", "2", "1", "--device=cpu",
                      "--gen.max_len_b=6", "--tx_dec.decoder_embed_dim=64",
                      "--tx_dec.encoder_embed_dim=64",
                      "--tx_dec.decoder_ffn_embed_dim=64",
                      "--tx_dec.encoder_ffn_embed_dim=64"])[0]
    _check_cpu_line(res, "srl_beam5_decode_latency_d1024")


@pytest.mark.parametrize("mode", bench.TRAINING_MODES)
def test_training_modes_are_not_ported_yet(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.main([mode, "--device=cpu"])


@pytest.mark.parametrize("mode,metric,accum", [
    ("vbtrain", "slowfast_vb_train_throughput", 1),
    ("vbtrain16", "slowfast_vb_train_throughput_bs2_accum2", 2),
])
def test_vb_train_modes_print_one_json_line_on_cpu(mode, metric, accum):
    torch.set_num_threads(1)
    (res,) = bench.main([mode, "1", "1", "--device=cpu",
                         "--vid_mdl.resnet.depth=26",
                         "--vid_mdl.crop_size=32", "--vid_mdl.num_frames=4"])
    _check_cpu_line(res, metric)
    assert res["unit"] == "videos/sec/cpu" and res["accum"] == accum
    assert res["videos"] == 1 and res["flops_per_step"] > 0


def test_unknown_mode_and_bad_flag_exit():
    with pytest.raises(SystemExit, match="unknown bench mode"):
        bench.main(["nonsense", "--device=cpu"])
    with pytest.raises(SystemExit, match="--key=value"):
        bench.main(["featext", "--oops"])


def test_gates_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="measure the card"):
        bench.main(["gates", "--device=cpu"])
    with pytest.raises(RuntimeError, match="measure the card"):
        gates.main(device="cpu")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["featext", "2", "1"])


def test_roofline_names_the_card_only_on_a_gpu():
    assert bench.roofline(1e9, 1e12, 1e-3, torch.device("cpu")) == dict.fromkeys(
        bench.ROOFLINE_KEYS)
    # no TPU constant and no analytic V100 anchor in the port's bench
    src = (REPO / "vidsitu_tpu_torch" / "bench.py").read_text()
    for word in ("V5E", "819", "vs_baseline", "GPU_BASELINE"):
        assert word not in src


@pytest.mark.parametrize("kind", sorted(CP.KERNELS))
def test_copy_probes_plain_version_is_the_identity(kind):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 256)).astype(np.float32)).to(torch.bfloat16)
    out = CP.probe_copy(x, kind)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert torch.equal(CP.copy_plain(x), x)
    with pytest.raises(ValueError, match="not CUDA"):
        CP.KERNELS[kind](x)  # the kernel wrappers never fall back
    assert not any(CP.LAUNCHES.values())


@pytest.mark.parametrize("block,match", [
    ((512, 2048), "shared memory"),   # the TPU probe's 2 MB block
    ((5, 64), "does not divide"),
    ((8, 4), "16-byte"),
])
def test_staged_copy_refuses_block_shapes_it_cannot_take(block, match):
    x = torch.zeros((6144, 4096), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        CP.probe_copy(x, "staged_copy", block=block)
    CP.check_block(x, (32, 2048))
    for tpu_block in gates.REFUSED_BLOCKS:
        with pytest.raises(ValueError):
            CP.check_block(torch.zeros((6144, 8192), dtype=torch.bfloat16),
                           tpu_block)
    for gpu_block in gates.STAGED_BLOCKS:
        CP.check_block(torch.zeros((768, 4096), dtype=torch.bfloat16),
                       gpu_block)


@pytest.mark.parametrize("budget,seg_min", [
    (201, 64), (61, 64), (201, 0), (1024, 64), (130, 32), (64, 64)])
def test_seg_schedule_equals_the_jax_bench(budget, seg_min):
    assert bench.seg_schedule(budget, seg_min) == jax_bench._seg_schedule(
        budget, seg_min)


@pytest.mark.parametrize("overrides,bs,beam", [
    ({}, 16, 5),
    ({"gen.max_len_b": 60, "tpu.seg_decode_min": 0}, 4, 1),
    ({**bench.REAL_TX, "gen.max_len_b": 2000, "tpu.seg_decode_min": 32}, 2, 5),
])
def test_decode_traffic_equals_the_jax_bench(overrides, bs, beam):
    cfg = get_cfg_with_overrides("traffic", **overrides)
    params = {"params": {"a": np.zeros((300, 7), np.float32),
                         "b": {"c": np.zeros(11, np.float32)}}}
    want = jax_bench._decode_traffic_bytes(cfg, params, bs, beam)
    got = bench.decode_traffic_bytes(cfg, (300 * 7 + 11) * 4, 4, bs, beam)
    assert got == want > 0
    # cut to the steps a decode really took: never more than the budget's
    assert bench.decode_traffic_bytes(
        cfg, (300 * 7 + 11) * 4, 4, bs, beam, steps=10) < got
    assert bench.decode_traffic_bytes(
        cfg, (300 * 7 + 11) * 4, 4, bs, beam, steps=10 ** 6) == got
