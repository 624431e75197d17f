"""Quick probe of the non-local attention's backward kernels on the card:
build, check, time. The short loop for work on the backward entries of
``csrc/nonlocal_attn.cu``; the whole picture (every listed shape in float32
too, the forward entries, the model's train step) is ``chip_smoke.py``
phases 2 and 16-18.

    python -m vidsitu_tpu_torch.attn_probe          # one GPU
    python -m vidsitu_tpu_torch.attn_probe --check  # no timing

It builds the source and prints the compiler's registers and spills of the
backward kernels (and any wgmma serialisation warning); holds both backward
entries, the wgmma one routed and the first one forced, against the plain
backward and the tiled plain version with each entry's tiles, in bf16, both
kinds, at ragged shapes and at the I3D-NL stage-3 / stage-4 shapes (B = 8),
and the wgmma entry against itself (two calls, bitwise equal); then times,
at B = 80 in bf16 softmax, the two entries, autograd of the plain attention
and the library's fused attention's backward in turns, and lists the
device time of each kernel of one call. Exits non-zero on a disagreement.
Seeded inputs; needs a GPU and nvcc.
"""

from __future__ import annotations

import math
import re
import subprocess
import sys

import numpy as np
import torch

from .ops import _build
from .ops import attention as A
from .timing import medians_in_turns

# (name, B, (Sq, Sk, d)): ragged ones first, against every tile of both
# passes; then the backbone's shapes
CHECKS = (("d64", 2, (70, 33, 64)), ("ragged", 8, (200, 200, 128)),
          ("ragged-d256", 8, (130, 57, 256)),
          ("ragged-d512", 3, (65, 196, 512)),
          ("s3", 8, (3136, 784, 256)), ("s4", 8, (784, 196, 512)))
TIMED = (("s3", (3136, 784, 256)), ("s4", (784, 196, 512)))
TIMED_B = 80
TOL = 5e-2  # of each gradient's scale, bf16
PEAK_BYTES_PER_S, PEAK_OPS_PER_S = 3.35e12, 989e12  # H100 SXM, bf16 dense


def grad_limit(ref: torch.Tensor) -> float:
    """5e-2 of the gradient's scale (largest |value|), or one bf16 step of
    it where that is more."""
    top = ref.float().abs().max().item()
    return max(TOL * top, 2.0 ** (math.floor(math.log2(top)) - 7))


def ptxas_lines(name: str = "nonlocal_attn", match: str = "nl_attn_bwd"):
    """(kernel, line) of the build log's register / spill reports and
    warnings for the kernels whose mangled name contains ``match``; the
    kernel named as ``function<type, D>``."""
    out, kernel = [], None
    for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            fn = re.search(r"(nl_attn_\w+?_kernel)I(13__nv_bfloat16|f)?(?:Li"
                           r"(\d+)E)?E", mangled)
            label = mangled[:60]
            if fn:
                dtype = {"f": "float", "13__nv_bfloat16": "bf16"}.get(
                    fn.group(2))
                args = ", ".join(a for a in (dtype, fn.group(3)) if a)
                label = f"{fn.group(1)}<{args}>"
            kernel = label if match in mangled else None
        elif kernel and any(w in line for w in ("Used", "spill", "C75",
                                                "arning")):
            out.append((kernel, line.split(":", 1)[-1].strip()))
    return out


def seeded(rng, b, sq, sk, d, dev):
    return [torch.from_numpy(rng.standard_normal((b, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for s in (sq, sk, sk, sq)]


def check(dev) -> bool:
    rng = np.random.default_rng(16)
    ok = True
    for name, b, (sq, sk, d) in CHECKS:
        q, k, v, do = seeded(rng, b, sq, sk, d, dev)
        for kind in A.KINDS:
            scale = d ** -0.5
            out, lse = A.fused_attention(q, k, v, kind, scale, with_lse=True)
            ref = A.attention_backward_reference(q, k, v, out, do, kind, scale)
            for entry in A.BWD_ENTRIES:
                got = A.fused_attention_backward(q, k, v, out, do, lse, kind,
                                                 scale, entry=entry)
                again = A.fused_attention_backward(q, k, v, out, do, lse,
                                                   kind, scale, entry=entry)
                til = A.attention_backward_tiled_reference(
                    q, k, v, out, do, lse, kind, scale, entry=entry)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                errs, good = [], same
                for g, r, t in zip(got, ref, til):
                    lim, top = grad_limit(r), r.float().abs().max().item()
                    e = (g.float() - r.float()).abs().max().item()
                    et = (g.float() - t.float()).abs().max().item()
                    good = good and g.dtype == q.dtype and max(e, et) <= lim
                    errs.append(f"{e / top:.2e}/{et / top:.2e}")
                ok = ok and good
                print(f"{name} B={b} {sq}x{sk}x{d} {kind} {entry}: dq/dk/dv "
                      f"error / scale vs plain/tiled {' '.join(errs)}; "
                      f"repeat {'bitwise' if same else 'DIFFERS'} "
                      f"{'ok' if good else 'FAIL'}", flush=True)
    print("launches by entry:", A.LAUNCHES_BY_ENTRY, flush=True)
    return ok


def backward_of(out, inputs, dout):
    return lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True)


def time_entries(dev) -> None:
    rng = np.random.default_rng(17)
    for name, (sq, sk, d) in TIMED:
        b, scale = TIMED_B, d ** -0.5
        q, k, v, do = seeded(rng, b, sq, sk, d, dev)
        out, lse = A.fused_attention(q, k, v, "softmax", scale, with_lse=True)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        plain = A.attention_reference(*leaves, "softmax", scale)
        l4 = [t.detach().unsqueeze(1).requires_grad_() for t in (q, k, v)]
        lib = torch.nn.functional.scaled_dot_product_attention(*l4,
                                                               scale=scale)
        ms = medians_in_turns([
            lambda: A.fused_attention_backward(q, k, v, out, do, lse,
                                               "softmax", scale),
            lambda: A.fused_attention_backward(q, k, v, out, do, lse,
                                               "softmax", scale,
                                               entry=A.BWD_ENTRY),
            backward_of(plain, leaves, do),
            backward_of(lib, l4, do.unsqueeze(1))], 5)
        flops = 5 * 2 * b * sq * sk * d
        moved = 2 * (q.nbytes + k.nbytes + v.nbytes) + out.nbytes + do.nbytes \
            + lse.nbytes
        bound = max(moved / PEAK_BYTES_PER_S, flops / PEAK_OPS_PER_S) * 1e3
        print(f"time {name} B={b} {sq}x{sk}x{d} bf16 softmax: "
              f"{A.bwd_kernel_entry(torch.bfloat16, d)} {ms[0]:.4f} ms "
              f"({100 * bound / ms[0]:.1f} % of the {bound:.4f} ms bound), "
              f"{A.BWD_ENTRY} {ms[1]:.4f}, plain autograd {ms[2]:.4f}, "
              f"scaled_dot_product_attention backward {ms[3]:.4f}", flush=True)
        print("    one call's kernels: " + "; ".join(
            f"{key} {kms:.4f} ms" for key, kms in kernel_times(
                lambda: A.fused_attention_backward(q, k, v, out, do, lse,
                                                   "softmax", scale))),
              flush=True)
        del leaves, plain, l4, lib
        torch.cuda.empty_cache()


def kernel_times(fn):
    """(kernel, device ms) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return [(re.sub(r"^void |\(.*$", "", e.key)[:48],
             e.self_device_time_total / 1e3) for e in rows]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build("nonlocal_attn")
    for kernel, line in ptxas_lines():
        print(f"ptxas {kernel}: {line}")
    if not check(dev):
        return 1
    if "--check" not in argv:
        time_entries(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
