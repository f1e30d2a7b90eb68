"""The wide GRU kernels' products under other compile-time choices.

    python -m diagnostics.ablate_gru_wide_gemm             # the backward
    python -m diagnostics.ablate_gru_wide_gemm --forward   # the forward

A one-off measurement, not a tool of the port: it edits the text of
`onpolicy_torch/csrc/gru_seq.cu` as it stands in the same commit, builds
each variant into a temporary directory (all builds at once), and stops
with an error as soon as an edit no longer matches the source.

Each variant fixes, for `gru_bwd_gates_gemm`, `gru_bwd_dw_gemm` and the
carry product of `gru_bwd_carry` each, how a k-step's three products
reach the accumulators: `add` (summed from zero and added in plain f32,
`mma3_add`) or `chain` (chained in the tensor cores' accumulator,
`mma3`), and the blocks an SM the GEMMs' launch bounds ask for (two,
128 registers a thread; or one, 255). The variant whose text equals the
source is marked `committed`.

For each variant, at the four H=512 shapes of `chip_smoke.HANABI_SHAPES`
(f32 streams, chip_smoke's inputs and seeds) it prints the largest
error of each piece and of the whole backward against the plain
versions (TF32 off): GH from the gate GEMM; dW and db from the dW GEMM
with its reduction, given the plain dG; the carry's outputs, given the
plain GH; the whole's six outputs; dW and db of the plain chain with
one kernel piece in it (`gates only`: the kernel's GH, the plain carry
and dW; `carry only`: the plain GH, the kernel's carry, the plain dW);
and the whole's and the f32 plain version's distance from the plain
version in f64 (`vs f64`, no tolerance). Beside each error against the
f32 plain version, the share of its tolerance it uses:
max |a - b| / (atol + rtol |b|), at chip_smoke's tolerances (GH 1e-5 /
1e-5, the rest rtol 2e-4 / atol 2e-5, dW and db relative to their
largest entry at the Hanabi shape); above 1 the check fails. Then the
compiler's registers and spills of the three f32 kernels, and, at the Hanabi
shape T=10 B=20,000 in two rounds (the second in reverse order), each
wide kernel's device ms (torch.profiler, 10 calls), with the card's name
and power limit, as one JSON object.

With `--forward` the variants are the wide forward's step kernel
(`gru_fwd_wide_step`) with its k-steps' products added in plain f32
(`add`, `mma3_add`) or chained in the accumulator (`chain`, `mma3`),
everything else as committed. At the same four shapes it prints the
largest error of outs and hT against the plain f32 version, with the
share of the forward's tolerance (1e-5 / 1e-5) it uses, and the
distance of both from the plain version in f64; then the compiler's
registers and spills of the f32 step kernel and its device ms at the
Hanabi shape in turns (add, chain, chain, add). Refuses to run without
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from onpolicy_torch.ops import cuda_gru as cg

_BOUNDS = "static constexpr int THREADS = 256, STAGES = 3, MIN_BLOCKS = {};"
_ACC = {"add": "for (int nt = 0; nt < G::NT; ++nt) mma3_add(acc[mt][nt], as, b[nt]);",
        "chain": "for (int nt = 0; nt < G::NT; ++nt) mma3(acc[mt][nt], as, b[nt]);"}
_GEMMS = {"gates": "gru_bwd_gates_gemm(", "dw": "gru_bwd_dw_gemm("}
_CARRY = {m: f"            {f}(acc[0][nt], a[0], b);\n"
             f"            {f}(acc[1][nt], a[1], b);"
          for m, f in (("add", "mma3_add"), ("chain", "mma3"))}
# (gates, dW, carry, blocks an SM)
VARIANTS = {f"gates_{g}_dw_{d}_carry_{c}" + ("" if b == 2 else "_1blk"):
            (g, d, c, b)
            for g, d, c, b in (("add", "add", "add", 2),
                               ("chain", "add", "add", 2),
                               ("add", "chain", "add", 2),
                               ("add", "add", "chain", 2),
                               ("chain", "chain", "chain", 2),
                               ("add", "add", "add", 1),
                               ("chain", "chain", "add", 1))}
KERNELS = ("gru_bwd_gates_gemm", "gru_bwd_carry", "gru_bwd_dw_gemm",
           "gru_bwd_reduce")
GRAD_TOL, GH_TOL = (2e-4, 2e-5), (1e-5, 1e-5)
FWD_TOL = (1e-5, 1e-5)
_FWD_ACC = {m: f"for (int gate = 0; gate < 3; ++gate) {f}(acc[mt][gate], "
               "hm, w[gate]);"
            for m, f in (("add", "mma3_add"), ("chain", "mma3"))}


def _edit(src: str, name: str, gates: str, dw: str, carry: str,
          blocks: int) -> str:
    """The source with each product's k-step accumulation and the GEMMs'
    launch bounds set as given."""
    bounds = [_BOUNDS.format(n) for n in (1, 2)]
    have = [b for b in bounds if b in src]
    if len(have) != 1:
        raise RuntimeError(f"{name}: the GEMMs' launch bounds do not match")
    src = src.replace(have[0], _BOUNDS.format(blocks))
    for kernel, mode in (("gates", gates), ("dw", dw)):
        start = src.find("\n" + _GEMMS[kernel])
        end = src.find("\n}\n", start)
        body = src[start:end]
        found = [m for m, line in _ACC.items() if body.count(line) == 1]
        if start < 0 or len(found) != 1:
            raise RuntimeError(f"{name}: {kernel} GEMM's accumulation does "
                               "not match")
        src = src[:start] + body.replace(_ACC[found[0]], _ACC[mode]) + src[end:]
    found = [m for m, text in _CARRY.items() if src.count(text) == 1]
    if len(found) != 1:
        raise RuntimeError(f"{name}: the carry's accumulation does not match")
    return src.replace(_CARRY[found[0]], _CARRY[carry])


def _edit_fwd(src: str, mode: str) -> str:
    """The source with the wide forward's k-step accumulation set."""
    found = [m for m, line in _FWD_ACC.items() if src.count(line) == 1]
    if len(found) != 1:
        raise RuntimeError("the wide forward's accumulation does not match")
    return src.replace(_FWD_ACC[found[0]], _FWD_ACC[mode])


def _build_all(tmp: Path, texts: dict):
    """Every variant's library (`texts`: name -> source) and compiler
    report, nvcc runs in parallel."""
    src = cg.SOURCE.read_text()
    jobs = {}
    for name, text in texts.items():
        path = tmp / f"{name}.cu"
        path.write_text(text)
        out = tmp / f"lib{name}.so"
        proc = subprocess.Popen([cg._nvcc(), *cg.NVCC_FLAGS, "-o", str(out),
                                 str(path)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, out, text == src)
    libs, report = {}, {}
    for name, (proc, out, committed) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lines = err.splitlines()
        report[name] = {"committed": committed}
        for i, line in enumerate(lines):
            kernel = next((k for k, tag in (("gates", "gates_gemmIf"),
                                            ("dw", "dw_gemmIf"),
                                            ("carry", "carryIf"),
                                            ("fwd", "wide_stepIf"))
                           if tag in line), None)
            if "Compiling entry" in line and kernel:
                report[name][kernel] = (f"{lines[i + 2].strip()}; "
                                        f"{lines[i + 3].strip()}")
        libs[name] = cg.bind(out)
    return libs, report


def _err(a, b, rtol, atol, scale=1.0):
    """(max |a - b| / scale, share of the tolerance used)."""
    a, b = a.float() / scale, b.float() / scale
    d = (a - b).abs()
    return float(d.max()), float((d / (atol + rtol * b.abs())).max())


def _errors(case, T, B, H, opts):
    """Each piece's and the whole's errors at one shape, as chip_smoke's
    check_layer makes its inputs."""
    big = opts.get("bench_scale", False)
    x = cs.make_inputs(torch, T, B, H, seed=T * 7919 + B * 31 + H,
                       mask_mode=opts.get("mask_mode", "sprinkled"))
    fargs = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
             x["b_hh"])
    outs, _ = cg.gru_layer_fwd_ref(*fargs)
    bargs = (x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    common = (outs, x["h0"], x["masks"])
    gh_ref = cg.gru_bwd_gates_ref(*common, x["w_hh"], x["b_hh"])
    cargs = (x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"])
    carry_ref = cg.gru_bwd_carry_ref(*cargs, gh_ref)
    dw_ref = cg.gru_bwd_dw_ref(*common, carry_ref[4])
    ref = cg.gru_layer_bwd_ref(*bargs)
    ref64 = cg.gru_layer_bwd_ref(*(a.double() for a in bargs))
    plain_vs_f64 = {n: float((b.double() - c).abs().max())
                    for n, b, c in zip(("dw_hh", "db_hh"), ref[4:], ref64[4:])}

    def scale(b):
        return max(1.0, float(b.abs().max())) if big else 1.0

    def run():
        out = {"GH": _err(cg.gru_bwd_gates(*common, x["w_hh"], x["b_hh"]),
                          gh_ref, *GH_TOL)}
        carry = cg.gru_bwd_carry(*cargs, gh_ref.clone())
        for n, a, b in zip(("dgir", "dgiz", "dgin", "dh0", "dG"), carry,
                           carry_ref):
            out[f"carry {n}"] = _err(a, b, *GRAD_TOL)
        for n, a, b in zip(("dw_hh", "db_hh"),
                           cg.gru_bwd_dw(*common, carry_ref[4]), dw_ref):
            out[f"dW GEMM {n}"] = _err(a, b, *GRAD_TOL, scale(b))
        gh = cg.gru_bwd_gates(*common, x["w_hh"], x["b_hh"])
        one = {"gates only": cg.gru_bwd_carry_ref(*cargs, gh)[4],
               "carry only": carry[4]}
        del gh
        for k, dg in one.items():
            for n, a, b in zip(("dw_hh", "db_hh"),
                               cg.gru_bwd_dw_ref(*common, dg), dw_ref):
                out[f"{k} {n}"] = _err(a, b, *GRAD_TOL, scale(b))
        del one, carry
        whole = cg.gru_layer_bwd(*bargs)
        for n, a, b in zip(("dgir", "dgiz", "dgin", "dh0", "dw_hh", "db_hh"),
                           whole, ref):
            out[f"whole {n}"] = _err(a, b, *GRAD_TOL,
                                     scale(b) if n in ("dw_hh", "db_hh")
                                     else 1.0)
        torch.cuda.synchronize()
        res = {k: {"err": e, "tol_use": u} for k, (e, u) in out.items()}
        for n, a, c in zip(("dw_hh", "db_hh"), whole[4:], ref64[4:]):
            res[f"whole {n} vs f64"] = {
                "err": float((a.double() - c).abs().max()),
                "plain_f32_err": plain_vs_f64[n]}
        return res

    return run, bargs


def _fwd_errors(T, B, H, opts):
    """outs and hT of the forward against the plain f32 and f64 versions
    at one shape, as chip_smoke's check_layer makes its inputs."""
    x = cs.make_inputs(torch, T, B, H, seed=T * 7919 + B * 31 + H,
                       mask_mode=opts.get("mask_mode", "sprinkled"))
    fargs = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
             x["b_hh"])
    ref = cg.gru_layer_fwd_ref(*fargs)
    ref64 = cg.gru_layer_fwd_ref(*(a.double() for a in fargs))
    plain = [float((b.double() - c).abs().max()) for b, c in zip(ref, ref64)]

    def run():
        got = cg.gru_layer_fwd(*fargs)
        torch.cuda.synchronize()
        res = {}
        for n, a, b, c, p in zip(("outs", "hT"), got, ref, ref64, plain):
            e, u = _err(a, b, *FWD_TOL)
            res[n] = {"err": e, "tol_use": u,
                      "vs_f64": float((a.double() - c).abs().max()),
                      "plain_f32_vs_f64": p}
        return res

    return run, fargs


def _forward(out):
    """The wide forward's accumulation, `add` against `chain`."""
    src = cg.SOURCE.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs, out["compiler"] = _build_all(
            Path(tmp), {f"fwd_{m}": _edit_fwd(src, m) for m in _FWD_ACC})
        try:
            for case, T, B, H, opts in cs.HANABI_SHAPES:
                run, fargs = _fwd_errors(T, B, H, opts)
                for name, lib in libs.items():
                    cg._lib = lib
                    out["errors"].setdefault(name, {})[case] = run()
                if (T, B, H) == tuple(cs.HANABI.values()):
                    hanabi_fargs = fargs
                del run, fargs
            names = list(libs)
            for name in names + names[::-1]:
                cg._lib = libs[name]
                out["device_ms"].setdefault(name, []).append(
                    cs.device_ms_each(
                        torch, lambda: cg.gru_layer_fwd(*hanabi_fargs),
                        ("gru_fwd_wide_step",), iters=10))
        finally:
            cg._lib = None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forward", action="store_true",
                    help="the wide forward's accumulation, not the backward's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gru_wide_gemm: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": card, "compiler": {}, "errors": {}, "device_ms": {}}
    if args.forward:
        _forward(out)
        print(json.dumps(out, indent=1))
        return
    src = cg.SOURCE.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs, out["compiler"] = _build_all(
            Path(tmp), {name: _edit(src, name, *cfg)
                        for name, cfg in VARIANTS.items()})
        try:
            for case, T, B, H, opts in cs.HANABI_SHAPES:
                run, bargs = _errors(case, T, B, H, opts)
                for name, lib in libs.items():
                    cg._lib = lib
                    out["errors"].setdefault(name, {})[case] = run()
                if (T, B, H) == tuple(cs.HANABI.values()):
                    hanabi_bargs = bargs
                del run, bargs
            for order in (list(libs), list(reversed(libs))):
                for name in order:
                    cg._lib = libs[name]
                    out["device_ms"].setdefault(name, []).append(
                        cs.device_ms_each(
                            torch, lambda: cg.gru_layer_bwd(*hanabi_bargs),
                            KERNELS, iters=10))
        finally:
            cg._lib = None
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
