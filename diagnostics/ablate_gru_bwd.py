"""Where the tensor-core GRU backward spends its time, by ablation.

    python -m diagnostics.ablate_gru_bwd [--rounds 2] [--streams f32|bf16]

A one-off measurement, not a tool of the port: it edits the text of
`onpolicy_torch/csrc/gru_seq.cu` as it stands in the same commit, and
stops with an error as soon as an edit no longer matches the source.

`ncu` does not run on the card's machine, so this script splits the time
of `gru_bwd_kernel_mma` another way: it builds variants of the source
with one part taken out (the gate product, the carry product, the dW
product, the two small 3xTF32 terms, the prefetch of the next step) or
one choice changed (the hi/lo split through `cvt.rna.tf32.f32`; fully
unrolled k-loops at 16-row tiles; `__expf` and a fast reciprocal in the
gate sigmoids) and times each against the whole kernel, in turns, on the
same card, with the [T, B, H] streams in f32 or (`--streams bf16`) in
bf16. The variants exist only in a temporary directory; those that take
a part out compute wrong results. Prints one JSON object: per variant,
the backward's device time
at the flagship shape (T=10, B=960, H=64; `torch.profiler`, kernel and
reduction) and its CUDA-event time at the bench shape (B=122,880), with
the compiler's register and spill report for the H=64 kernels and the
card's name and power limit. Refuses to run without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from onpolicy_torch.ops import cuda_gru as cg

FLAGSHIP = (10, 960, 64)
BENCH = (10, 122_880, 64)
# variant -> edits of the source (each must match exactly once)
VARIANTS = {
    "whole": [],
    "no_gate_product": [("mma3(gh[gate], split(af), b);", "")],
    "no_carry_product": [("mma3(d[gate], split(af), split(bf));", "")],
    "no_dw_product": [("mma3(acc_w[mt][j], a, b[j]);", ";")],
    "one_tf32_term": [("  mma_tf32(d, a.lo, b.hi);\n  mma_tf32(d, a.hi, b.lo);\n",
                       "")],
    "no_prefetch": [("if (ntile < ntiles)\n          stage_step",
                     "if (false)\n          stage_step")],
    # two choices of the design, undone: the split through the conversion
    # instruction, and fully unrolled k-loops at 16-row tiles
    "cvt_rna_split": [(
        "    s.hi[i] = __float_as_uint(x[i]) & 0xffffe000u;\n"
        "    s.lo[i] = __float_as_uint(x[i] - __uint_as_float(s.hi[i]));",
        "    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(s.hi[i]) : \"f\"(x[i]));\n"
        "    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(s.lo[i])\n"
        "        : \"f\"(x[i] - __uint_as_float(s.hi[i])));")],
    "full_unroll": [("constexpr int kUnroll = BT == 16 ? 2 : H / 8;",
                     "constexpr int kUnroll = H / 8;")],
    # what the accurate sigmoid of the gate math costs
    "fast_sigmoid": [
        ("template <int N>\nstruct Split {",
         "__device__ __forceinline__ float sigmoid_fast(float x) {\n"
         "  return __fdividef(1.0f, 1.0f + __expf(-x));\n}\n\n"
         "template <int N>\nstruct Split {"),
        ("const float rg = sigmoid_(to_f32(st[o])",
         "const float rg = sigmoid_fast(to_f32(st[o])"),
        ("const float zg = sigmoid_(to_f32(st[L::STREAM + o])",
         "const float zg = sigmoid_fast(to_f32(st[L::STREAM + o])")],
}


def _instance(line: str, prefix: str) -> str:
    """`<H,BT,type>` of a kernel from its mangled name in a ptxas line."""
    args = line.split(prefix)[1].split("EEvPK")[0]
    return "<" + (args.replace("E13__nv_bfloat16", ",bf16")
                  .replace("Ef", ",f32").replace("ELi", ",")) + ">"


def _build(tmp: Path, name: str, edits):
    src = cg.SOURCE.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: edit does not match the source once")
        src = src.replace(old, new)
    path = tmp / f"{name}.cu"
    path.write_text(src)
    out = tmp / f"lib{name}.so"
    res = subprocess.run([cg._nvcc(), *cg.NVCC_FLAGS, "-o", str(out), str(path)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
    lines = res.stderr.splitlines()
    report = [f"{_instance(lines[i], 'gru_bwd_kernel_mmaILi')}: "
              f"{lines[i + 2].strip()}; {lines[i + 3].split(':', 1)[1].strip()}"
              for i, l in enumerate(lines)
              if "Compiling entry" in l and "gru_bwd_kernel_mmaILi64" in l]
    return cg.bind(out), report


def _inputs(T, B, H, dtype, seed=11):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device="cuda") * scale
    gir, giz, gin = (rn(T, B, H).to(dtype) for _ in range(3))
    h0, masks = rn(B, H, scale=0.5), torch.ones(T, B, 1, device="cuda")
    w_hh, b_hh = rn(H, 3 * H, scale=H ** -0.5), rn(3 * H, scale=0.1)
    outs, _ = cg.gru_layer_fwd_ref(gir, giz, gin, h0, masks, w_hh, b_hh)
    return (gir, giz, gin, outs, h0, masks, rn(T, B, H, scale=0.1).to(dtype),
            rn(B, H, scale=0.1), w_hh, b_hh)


def _event_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if "gru_bwd" in e.key:
            us += float(getattr(e, "self_device_time_total", 0.0)
                        or getattr(e, "self_cuda_time_total", 0.0))
    return us / iters / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--streams", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.streams == "bf16" else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gru_bwd: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    flag, bench = _inputs(*FLAGSHIP, dtype), _inputs(*BENCH, dtype)
    out = {"card": card, "streams": args.streams, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        builds = {name: pool.submit(_build, Path(tmp), name, edits)
                  for name, edits in VARIANTS.items()}
        libs = {}
        for name, fut in builds.items():
            libs[name], report = fut.result()
            out["variants"][name] = {"ptxas_h64": report, "flagship_device_ms": [],
                                     "bench_event_ms": []}
        try:
            for _ in range(args.rounds):
                for name, lib in libs.items():
                    cg._lib = lib
                    row = out["variants"][name]
                    row["flagship_device_ms"].append(
                        _device_ms(lambda: cg.gru_layer_bwd(*flag)))
                    row["bench_event_ms"].append(
                        _event_ms(lambda: cg.gru_layer_bwd(*bench)))
        finally:
            cg._lib = None
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
