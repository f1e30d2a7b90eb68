"""Where the tensor-core GRU forward spends its time, by ablation.

    python -m diagnostics.ablate_gru_fwd [--rounds 2] [--streams f32|bf16]

A one-off measurement, not a tool of the port: it edits the text of
`onpolicy_torch/csrc/gru_seq.cu` as it stands in the same commit, and
stops with an error as soon as an edit no longer matches the source.

`ncu` does not run on the card's machine, so this script splits the time
of `gru_fwd_kernel_mma` another way. It builds variants of the source
with one part taken out (the gate product; the two small 3xTF32 terms;
the overlap of the copies with the compute; the copies themselves; the
stores of outs) or one choice changed (more cp.async stages; one
accumulator chain a gate; W split into hi/lo once, in shared memory;
outs written through shared memory in vectors), and launches the whole
kernel on other tiles (16-row tiles at the flagship shape, 8-row tiles
at the bench shape). It times each against the whole kernel, in turns,
on the same card, with the [T, B, H] streams in f32 or (`--streams bf16`)
in bf16. The variants exist only in a temporary directory; those that
take a part out compute wrong results. Prints one JSON object: per
variant, the forward's device time
at the flagship shape (T=10, B=960, H=64; `torch.profiler`), its
CUDA-event time at the bench shape (B=122,880), its largest error against
the plain version at both shapes, and the compiler's register and spill
report for the H=64 kernels, with the card's name and power limit.
Refuses to run without a CUDA device.
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

STAGES = "  static constexpr int STAGES = 2;"
MMA_SMALL = ("          mma_tf32(small[gate], a.lo, b.hi);\n"
             "          mma_tf32(small[gate], a.hi, b.lo);\n")
MMA_BIG = "          mma_tf32(big[gate], a.hi, b.hi);\n"
PREFETCH = "      issue();          // into the stage that the last step read\n"
W_FILL = ("    dst[(m & 7) * 16] = v.x;\n"
          "    dst[((m + 1) & 7) * 16] = v.y;\n"
          "    dst[((m + 2) & 7) * 16] = v.z;\n"
          "    dst[((m + 3) & 7) * 16] = v.w;\n")
W_LOAD = ("          const float4 w = wf[(gate * MT * KT + kt) * 32];\n"
          "          const float af[4] = {w.x, w.y, w.z, w.w};\n"
          "          const Split<4> a = split(af);\n")
OUTS_STORE = ("        if (row0 + n < B) outs[(tb + row0 + n) * H + j] = "
              "from_f32<S>(h[p]);\n")
STAGE_OFF = "  static constexpr int STAGE_OFF = 4 * H3 * H;   // after W^T"
HELPERS = "template <int N>\nstruct Split {"
# four f32 values stored as stream elements: one 16-byte (f32) or 8-byte
# (bf16) store
STORE4 = (
    "__device__ __forceinline__ void store4(float* p, float4 v) {\n"
    "  *reinterpret_cast<float4*>(p) = v;\n}\n"
    "__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {\n"
    "  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v.x, v.y);\n"
    "  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v.z, v.w);\n"
    "}\n\n")
TILE_END = ("      hb ^= 1;\n    }\n#pragma unroll\n    for (int p = 0; p < 4; ++p) {\n"
            "      const int row = row0 + n0")


def _store_tile(step: str) -> str:
    return (
        "        {\n"
        "          const float* hsrc = sH + hb * L::HTILE;\n"
        "          for (int e = tid; e < BT * H / 4; e += L::THREADS) {\n"
        "            const int r = e / (H / 4), c = (e % (H / 4)) * 4;\n"
        "            if (row0 + r < B)\n"
        f"              store4(outs + ((size_t)({step}) * B + row0 + r) * H + c,\n"
        "                     *reinterpret_cast<const float4*>(hsrc + r * HSS + c));\n"
        "          }\n"
        "        }\n")


# variant -> (edits of the source, each matching exactly once; launch
# options: stages and presplit set the shared bytes, flag_bt / bench_bt
# the tile, bench_grid the blocks at the bench shape)
VARIANTS = {
    "whole": ([], {}),
    "stages_3": ([(STAGES, STAGES.replace("2", "3"))], {"stages": 3}),
    "stages_4": ([(STAGES, STAGES.replace("2", "4"))], {"stages": 4}),
    "no_overlap": ([(PREFETCH, PREFETCH + "      cp_async_wait_all();\n")], {}),
    "no_copies": ([(PREFETCH, "")], {}),
    "no_outs_store": ([(OUTS_STORE, "")], {}),
    "no_gate_product": ([(MMA_SMALL + MMA_BIG, "")], {}),
    "one_tf32_term": ([(MMA_SMALL, "")], {}),
    "one_chain_per_gate": ([(MMA_BIG, MMA_BIG.replace("big", "small"))], {}),
    "presplit_w": ([
        (STAGE_OFF, STAGE_OFF.replace("4 * H3", "8 * H3")),
        (W_FILL,
         "    const float vv[4] = {v.x, v.y, v.z, v.w};\n"
         "    for (int d = 0; d < 4; ++d) {\n"
         "      const float hi = __uint_as_float(__float_as_uint(vv[d]) & 0xffffe000u);\n"
         "      dst[((m + d) & 7) * 16] = hi;\n"
         "      dst[H3 * H + ((m + d) & 7) * 16] = vv[d] - hi;\n"
         "    }\n"),
        (W_LOAD,
         "          const float4 w = wf[(gate * MT * KT + kt) * 32];\n"
         "          const float4 wl = wf[H3 * H / 4 + (gate * MT * KT + kt) * 32];\n"
         "          Split<4> a;\n"
         "          a.hi[0] = __float_as_uint(w.x); a.hi[1] = __float_as_uint(w.y);\n"
         "          a.hi[2] = __float_as_uint(w.z); a.hi[3] = __float_as_uint(w.w);\n"
         "          a.lo[0] = __float_as_uint(wl.x); a.lo[1] = __float_as_uint(wl.y);\n"
         "          a.lo[2] = __float_as_uint(wl.z); a.lo[3] = __float_as_uint(wl.w);\n")],
        {"presplit": True, "bench_grid": 132}),
    "outs_via_shared": ([
        (HELPERS, STORE4 + HELPERS),
        (PREFETCH, PREFETCH + "      if (t > 0)\n" + _store_tile("t - 1")),
        (OUTS_STORE, ""),
        (TILE_END,
         "      hb ^= 1;\n    }\n    __syncthreads();\n" + _store_tile("T - 1")
         + "    hb ^= 1;\n#pragma unroll\n    for (int p = 0; p < 4; ++p) {\n"
         "      const int row = row0 + n0")],
        {}),
    "flagship_tile16": ([], {"flag_bt": 16}),
    "bench_tile8": ([], {"bench_bt": 8}),
}


def _smem_bytes(H, bt, itemsize, stages=2, presplit=False):
    """`FwdLayout<H, BT, S>::BYTES` with `stages` stages and W^T stored
    once or (presplit) as hi and lo."""
    stage = 3 * bt * cg._staged_row(H, itemsize) + 4 * bt
    return (4 * 3 * H * H * (2 if presplit else 1) + stages * stage
            + 4 * 2 * bt * (H + 4))


def _plan(shape, opts, n_sm, itemsize):
    _, B, H = shape
    key = "flag" if shape == FLAGSHIP else "bench"
    default = cg.fwd_plan(B, H, n_sm, 232_448, itemsize)
    bt = opts.get(f"{key}_bt", default.bt)
    grid = min(-(-B // bt), opts.get(f"{key}_grid", 2 * n_sm))
    return cg.FwdPlan(cg.MMA, bt, grid,
                      _smem_bytes(H, bt, itemsize, opts.get("stages", 2),
                                  opts.get("presplit", False)))


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
    report = [f"{_instance(lines[i], 'gru_fwd_kernel_mmaILi')}: "
              f"{lines[i + 2].strip()}; {lines[i + 3].split(':', 1)[1].strip()}"
              for i, l in enumerate(lines)
              if "Compiling entry" in l and "gru_fwd_kernel_mmaILi64" in l]
    return out, report


def _inputs(T, B, H, dtype, seed=11):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device="cuda") * scale
    masks = (torch.rand(T, B, 1, generator=g, device="cuda") > 0.1).float()
    masks[0] = 0.0
    args = (rn(T, B, H).to(dtype), rn(T, B, H).to(dtype), rn(T, B, H).to(dtype),
            rn(B, H, scale=0.5), masks, rn(H, 3 * H, scale=H ** -0.5),
            rn(3 * H, scale=0.1))
    return args, cg.gru_layer_fwd_ref(*args)


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
        if "gru_fwd" in e.key:
            us += float(getattr(e, "self_device_time_total", 0.0)
                        or getattr(e, "self_cuda_time_total", 0.0))
    return us / iters / 1e3


def _err(args, ref, plan):
    outs, hT = cg.gru_layer_fwd(*args, plan=plan)
    return max(float((outs.float() - ref[0].float()).abs().max()),
               float((hT - ref[1]).abs().max()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--streams", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.streams == "bf16" else torch.float32
    itemsize = 2 if args.streams == "bf16" else 4
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gru_fwd: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    flag, bench = _inputs(*FLAGSHIP, dtype), _inputs(*BENCH, dtype)
    out = {"card": card, "streams": args.streams, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        builds = {name: pool.submit(_build, Path(tmp), name, edits)
                  for name, (edits, _) in VARIANTS.items()}
        libs = {}
        for name, fut in builds.items():
            path, report = fut.result()
            libs[name] = cg.bind(path)
            opts = VARIANTS[name][1]
            out["variants"][name] = {
                "ptxas_h64": report,
                "flagship_plan": _plan(FLAGSHIP, opts, n_sm, itemsize)._asdict(),
                "bench_plan": _plan(BENCH, opts, n_sm, itemsize)._asdict(),
                "flagship_device_ms": [], "bench_event_ms": []}
        try:
            for name, lib in libs.items():
                cg._lib = lib
                row = out["variants"][name]
                fp, bp = (cg.FwdPlan(**row[k]) for k in ("flagship_plan",
                                                         "bench_plan"))
                row["flagship_err"] = _err(*flag, fp)
                row["bench_err"] = _err(*bench, bp)
            for _ in range(args.rounds):
                for name, lib in libs.items():
                    cg._lib = lib
                    row = out["variants"][name]
                    fp, bp = (cg.FwdPlan(**row[k]) for k in ("flagship_plan",
                                                             "bench_plan"))
                    row["flagship_device_ms"].append(
                        _device_ms(lambda: cg.gru_layer_fwd(*flag[0], plan=fp)))
                    row["bench_event_ms"].append(
                        _event_ms(lambda: cg.gru_layer_fwd(*bench[0], plan=bp)))
        finally:
            cg._lib = None
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
