"""Where the CUDA-core GRU kernels spend their time at H=512, by ablation.

    python -m diagnostics.ablate_gru_cuda_core [--rounds 2]

A one-off measurement, not a tool of the port: it edits the text of
`onpolicy_torch/csrc/gru_seq.cu` as it stands in the same commit, and
stops with an error as soon as an edit no longer matches the source.

At the Hanabi shape (T=10, B=20,000, H=512, f32 streams; the plans take
`cuda_core_global_w`, W read from device memory, 1250 blocks of 16 rows)
it builds variants of the source with one part of `gru_bwd_kernel` or
`gru_fwd_kernel` taken out, or kept but not stored, and times each
against the whole kernel in turns on the same card (CUDA events):
  backward: the gate product (hm·W), the carry product (dG·Wᵀ, which
  reads W transposed, each thread its own row), the dW product with its
  read-modify-write of the block's partial in device memory, and the
  read-modify-write alone (the product kept, its result stored only on a
  value it never takes);
  forward: the gate product.
The variants exist only in a temporary directory, and those that take a
part out compute wrong results. Prints one JSON object: per variant, the
kernel's CUDA-event ms per call in each round, with the card's name and
power limit. Refuses to run without a CUDA device.
`gru_bwd_kernel` runs by default only for H outside the wide backward's
widths (64 < H <= 512, H % 32 == 0); here it is asked for through an
explicit plan (`cuda_gru.cuda_core_bwd_plan`).
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

HANABI = (10, 20_000, 512)
# the CUDA-core gate product; what follows it tells the two kernels apart
_GATE_LOOP = """      for (int k = 0; k < H; ++k) {
        const float* wk = W + k * ws + j;
        const float wr = wk[0], wz = wk[H], wn = wk[2 * H];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float h = hm[rr * H + k];
          ar[rr] = fmaf(h, wr, ar[rr]);
          az[rr] = fmaf(h, wz, az[rr]);
          an[rr] = fmaf(h, wn, an[rr]);
        }
      }
      const float br = b_hh[j], bz = b_hh[H + j], bn = b_hh[2 * H + j];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = g * kRows + rr;
        const int row = row0 + r;
"""
_BWD_TAIL = "        const int s = r * H + j;\n"
_FWD_TAIL = "        if (row >= B) continue;\n"


def _without_gate_loop(tail):
    head, rest = _GATE_LOOP.split("      const float br", 1)
    return (_GATE_LOOP + tail, "      const float br" + rest + tail)


# variant -> (kernel timed, edits of the source, each matching exactly once)
VARIANTS = {
    "bwd_whole": ("bwd", []),
    "bwd_no_gate_product": ("bwd", [_without_gate_loop(_BWD_TAIL)]),
    "bwd_no_carry_product": ("bwd", [(
        "for (int rr = 0; rr < kRows; ++rr) d[rr] = fmaf(G[rr * H + j], wv, "
        "d[rr]);", ";")]),
    "bwd_no_dw": ("bwd", [("      acc[e] += s;\n", "      (void)s;\n")]),
    "bwd_dw_product_no_rmw": ("bwd", [(
        "      acc[e] += s;\n", "      if (s == 1234.5f) acc[e] = s;\n")]),
    "fwd_whole": ("fwd", []),
    "fwd_no_gate_product": ("fwd", [_without_gate_loop(_FWD_TAIL)]),
}


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
    return cg.bind(out)


def _inputs(T, B, H, seed=11):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device="cuda") * scale
    gir, giz, gin = (rn(T, B, H) for _ in range(3))
    h0, masks = rn(B, H, scale=0.5), torch.ones(T, B, 1, device="cuda")
    w_hh, b_hh = rn(H, 3 * H, scale=H ** -0.5), rn(3 * H, scale=0.1)
    outs, _ = cg.gru_layer_fwd_ref(gir, giz, gin, h0, masks, w_hh, b_hh)
    fwd = (gir, giz, gin, h0, masks, w_hh, b_hh)
    bwd = (gir, giz, gin, outs, h0, masks, rn(T, B, H, scale=0.1),
           rn(B, H, scale=0.1), w_hh, b_hh)
    return {"fwd": (cg.gru_layer_fwd, fwd), "bwd": (_cuda_core_bwd, bwd)}


def _cuda_core_bwd(*args):
    """The CUDA-core backward, which the default plan no longer takes at
    H=512; the card's limits are read through the library in use."""
    _, B, H = args[0].shape
    limits = cg.device_limits(torch.cuda.current_device())
    return cg.gru_layer_bwd(*args, plan=cg.cuda_core_bwd_plan(B, H, *limits))


def _event_ms(fn, iters):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gru_cuda_core: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    calls = _inputs(*HANABI)
    out = {"card": card, "shape": dict(zip("TBH", HANABI)), "variants": {}}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        builds = {name: pool.submit(_build, Path(tmp), name, edits)
                  for name, (_, edits) in VARIANTS.items()}
        libs = {name: fut.result() for name, fut in builds.items()}
        try:
            for _ in range(args.rounds):
                for name, lib in libs.items():
                    cg._lib = lib
                    which = VARIANTS[name][0]
                    fn, call_args = calls[which]
                    out["variants"].setdefault(name, []).append(_event_ms(
                        lambda: fn(*call_args), 10 if which == "fwd" else 3))
        finally:
            cg._lib = None
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
