"""The ICNN product routines of the kernels, alone, on the card.

    python3 -m tools.product_bench [--parent DIR]

Builds ``tools/csrc/product_bench.cu`` once per variant below (one nvcc
each, all started together, in ``build/product_bench/<variant>/`` beside
its copies of the two routine sources) and prints one JSON line with the
card and:

- ``rates``: what one SM issues per cycle, every SM running one block of
  256 threads (``clock64``): FP32 FMAs, TF32 ``mma.sync.m16n8k8`` (alone,
  and with the ``cvt.rna`` splits a 3xTF32 step needs), bf16 ``m16n8k16``,
  the latency of one chain of TF32 MMAs, conflict-free 32- and 128-bit
  shared loads, and 128-bit loads that each half-warp broadcasts from one
  address (bytes counted per thread, as for the others);
- ``routines``: cycles per call of the three ICNN products of one chunk
  of 64 points (and, as ``*_tp32``, of 32) at the bench model's ICNN
  width, one block of 256 threads per SM under the flagship kernel's
  launch bounds, with the operands in shared memory and the weights in
  global memory as in the kernel: ``mm_rows`` forward (``fwd``) and
  backward data (``bwd``) and ``wgrad_tiled`` (``wgrad``) from
  ``awesome_tpu_torch/ops/csrc/flagship.cu`` as it is, the bf16 build's
  tensor-core routines there (``bf_*``: ``mm_rows_bf16``, ``wgrad_bf16``),
  and the 3xTF32 routines of ``tools/csrc/mma_tf32_trial.cuh``
  (``tc_*``). Variant ``full`` checks every routine's output against an
  FP64 product (for ``bf_*``, of the operands rounded to bf16) and fails
  above ``RTOL`` (of the largest output). ``ptxas`` gives each routine's
  registers and spills.

The other variants cut parts of the weight staging of the forward and
backward-data routines (both kinds) out of the source text, so their
output is wrong and only their cycles are read: ``nofetch`` (no global
loads of the weights), ``nostash`` (no stores of a slab into shared
memory), ``nobar`` (no barrier after each slab) and ``inner`` (all three:
the inner product loop alone). The weight-grad routines stage nothing and
are the same in these; ``noold`` cuts only their reads of the old
partial-row values (the stores stay), and ``normw`` the whole
read-modify-write through L2. ``nocvt`` packs the bf16 routines' operands
by truncation (two integer ops) instead of ``cvt.rn.bf16x2.f32``, which
says what the conversions cost.

``icnn_routines`` gives the same three products as the ICNN kernels K4
and K5 run them (``awesome_tpu_torch/ops/csrc/icnn.cu``, built into
``tools/csrc/icnn_bench.cu``, a translation unit of its own since both
kernel sources define the same names; ``*_res`` the forward and
backward-data products with the weight resident in shared memory, as the
kernels take it with one hidden layer), each checked against an FP64
product: ``this`` is this checkout's source, ``parent`` the one under
``--parent DIR`` (e.g. the parent commit unpacked with ``git archive``
under ``build/``). This checkout's routines are also built cut as above
(``nofetch``, ``nobar``, ``inner``; no check).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from awesome_tpu_torch.ops.build import NVCC_FLAGS, check, nvcc
from chip_smoke import nvidia_smi_line

ROOT = Path(__file__).resolve().parents[1]
KERNEL = ROOT / "awesome_tpu_torch" / "ops" / "csrc" / "flagship.cu"
TRIAL = ROOT / "tools" / "csrc" / "mma_tf32_trial.cuh"
BENCH = ROOT / "tools" / "csrc" / "product_bench.cu"
ICNN = Path("awesome_tpu_torch") / "ops" / "csrc" / "icnn.cu"
ICNN_BENCH = ROOT / "tools" / "csrc" / "icnn_bench.cu"
OUT = ROOT / "build" / "product_bench"

WIDTH = 130  # the bench model's ICNN width
TP = 64  # points per chunk: the bench model's instantiation
REPS = 20  # timed calls of each routine
SMS = 132  # blocks: one per SM of an H100 SXM
TPS = (64, 32)  # the flagship kernel's two tile instantiations
RTOL = 1e-5
ROUTINES = ("fwd", "bwd", "wgrad", "tc_fwd", "tc_bwd", "tc_wgrad", "bf_fwd",
            "bf_bwd", "bf_wgrad")
ICNN_ROUTINES = ROUTINES[:3] + ("fwd_res", "bwd_res")
# the interface of icnn.cu's routines before float4 operands (API 1)
ICNN_API1 = "float* out, int ld, bool first)"
MODES = ("ffma", "mma_tf32", "mma_tf32_split", "mma_bf16", "mma_chain",
         "lds32", "lds128", "lds128_bcast")

# (text, replacement) in the FMA routine, the bf16 routine and the 3xTF32
# routine (the bf16 and 3xTF32 routines share their barrier's text)
FETCH = [("? __ldcg(A + (size_t)m * sr + (size_t)c * sc)",
          "? (float)(m - c)"),
         ("in && c < K ? __ldcg(a) : 0.f",
          "in && c < K ? (float)(m - c) : 0.f"),
         ("in && c + 1 < K ? __ldcg(a + sc) : 0.f",
          "in && c + 1 < K ? (float)(m + c) : 0.f")]
STASH = [("if (idx < KB * T::RT) dst[cc * T::ASTR + r] = pre[l];",
          "if (idx < KB * T::RT && M < 0)\n          dst[cc * T::ASTR + r] = "
          "pre[l];"),
         ("if (idx < KB * T::RT)\n          split_tf32(",
          "if (idx < KB * T::RT && M < 0)\n          split_tf32("),
         ("if (idx < KP * T::RT)\n          dst[r * SW + cp]",
          "if (idx < KP * T::RT && M < 0)\n          dst[r * SW + cp]")]
BAR = [("stash(As + ((s + 1) & 1) * T::SLAB);\n      __syncthreads();",
        "stash(As + ((s + 1) & 1) * T::SLAB);"),
       ("if (s + 1 < nslab) stash(s + 1);\n      __syncthreads();",
        "if (s + 1 < nslab) stash(s + 1);")]
# the weight grads' reads of the old partial-row values (the stores stay)
OLD = [("? 0.f : __ldcg(out + m * ld + k);", "? 0.f : 0.f;"),
       ("? __ldcg(out + (m0 + r) * ld + k)", "? 0.f"),
       ("? __ldcg(orow[r] + dk)", "? 0.f")]
# no read-modify-write at all (the stores kept behind a test that fails)
STORE = [("if (k < K) __stcg(out + m * ld + k,",
          "if (k < K && M < 0) __stcg(out + m * ld + k,"),
         ("if (kin && m0 + r < M) __stcg(",
          "if (kin && m0 + r < M && M < 0) __stcg("),
         ("if (mlive[r] && kb + dk < kend)\n          __stcg(",
          "if (mlive[r] && kb + dk < kend && M < 0)\n          __stcg(")]
# the bf16 routines' conversions: operands packed by truncation (two
# integer ops) instead of cvt.rn.bf16x2.f32
CVT = [("  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
        "  return *reinterpret_cast<const uint32_t*>(&v);",
        "  return (__float_as_uint(lo) >> 16) |\n"
        "         (__float_as_uint(hi) & 0xffff0000u);")]
VARIANTS = {"full": [], "nofetch": FETCH, "nostash": STASH, "nobar": BAR,
            "inner": FETCH + STASH + BAR, "noold": OLD, "normw": OLD + STORE,
            "nocvt": CVT}
# the staging cuts must reach the FMA and the 3xTF32 routines alike
STAGING_CUTS = ("nofetch", "nostash", "nobar", "inner")
# the same cuts in icnn.cu's routines (this checkout's): no weight copies,
# no barrier a slab, neither
ICNN_FETCH = [("        cp_async4(dst + r * T::AST + cc,",
               "        if (M < 0) cp_async4(dst + r * T::AST + cc,")]
ICNN_BAR = [("        __syncthreads();  // slab s landed",
             "        // slab s landed")]
ICNN_VARIANTS = {"full": [], "nofetch": ICNN_FETCH, "nobar": ICNN_BAR,
                 "inner": ICNN_FETCH + ICNN_BAR}


def compile_bench(d: Path, src: Path, names, flags=()):
    """nvcc ``src`` (in ``d``) into ``d``; returns (library path, ptxas
    lines per routine in ``names``)."""
    lib = d / f"lib{src.stem}.so"
    res = subprocess.run([nvcc(), *NVCC_FLAGS, *flags, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {d.name}:\n{res.stderr[-3000:]}")
    # ptxas names each kernel (routine<64, R> mangles to
    # ...routineILi64ELi<R>EE...), then gives its registers and spills
    lines, kernel = {}, None
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"routineILi(\d+)ELi(\d)EE", line)
            kernel = (name_at(names[int(m.group(2))], int(m.group(1)))
                      if m else None)
        elif kernel and ("registers" in line or "spill" in line):
            lines.setdefault(kernel, []).append(
                line.split("ptxas info")[-1].strip(" :"))
    return lib, lines


def build_icnn(label: str, root: Path, variant: str = "full"):
    """Compile the ICNN bench against ``root``'s icnn.cu, cut as
    ``variant`` says."""
    d = OUT / f"icnn_{label}_{variant}"
    d.mkdir(parents=True, exist_ok=True)
    src = (root / ICNN).read_text()
    for old, new in ICNN_VARIANTS[variant]:
        if src.count(old) != 1:
            raise RuntimeError(f"icnn {variant}: {old!r} is not in icnn.cu")
        src = src.replace(old, new)
    (d / ICNN.name).write_text(src)
    (d / ICNN_BENCH.name).write_text(ICNN_BENCH.read_text())
    api = 1 if ICNN_API1 in src else 2
    names = ICNN_ROUTINES[:3] if api == 1 else ICNN_ROUTINES
    return compile_bench(d, d / ICNN_BENCH.name, names,
                         (f"-DICNN_BENCH_API={api}",)) + (names,)


def build(name: str):
    """Patch copies of the kernel and the trial header and compile the
    bench against them; returns (library path, ptxas lines)."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    texts = {KERNEL.name: KERNEL.read_text(), TRIAL.name: TRIAL.read_text()}
    patched = set()
    for old, new in VARIANTS[name]:
        hits = [f for f, s in texts.items() if s.count(old) == 1]
        if not hits:
            raise RuntimeError(f"{name}: {old!r} is in no routine source")
        for f in hits:
            texts[f] = texts[f].replace(old, new)
        patched.update(hits)
    if name in STAGING_CUTS and patched != set(texts):
        raise RuntimeError(f"{name} leaves {set(texts) - patched} as it is")
    # the bench source goes beside the patched copies: a quoted #include
    # looks in the including file's own directory first
    texts[BENCH.name] = BENCH.read_text()
    for f, s in texts.items():
        (d / f).write_text(s)
    return compile_bench(d, d / BENCH.name, ROUTINES)


def name_at(name: str, tp: int) -> str:
    return name if tp == TPS[0] else f"{name}_tp{tp}"


def load(lib: Path) -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(lib))
    args = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    if hasattr(cdll, "product_bench_routine"):
        cdll.product_bench_routine.argtypes = args + [ctypes.c_int]
    if hasattr(cdll, "icnn_bench_routine"):
        cdll.icnn_bench_routine.argtypes = args
    if hasattr(cdll, "product_bench_rate"):
        cdll.product_bench_rate.argtypes = \
            [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    return cdll


def rates(cdll) -> dict:
    """FLOP (or shared-memory bytes) per cycle per SM of each mode."""
    iters = 2000
    # per warp and iteration: FLOP, or bytes for the loads
    work = {"ffma": 8 * 32 * 32 * 2, "mma_tf32": 8 * 2048,
            "mma_tf32_split": 8 * 2048, "mma_bf16": 8 * 4096,
            "mma_chain": 2048, "lds32": 8 * 32 * 4, "lds128": 8 * 32 * 16,
            "lds128_bcast": 8 * 32 * 16}
    threads = 256
    sink = torch.empty(SMS * threads, device="cuda")
    cyc = torch.zeros(SMS, dtype=torch.int64, device="cuda")
    out = {}
    for i, mode in enumerate(MODES):
        check(cdll.product_bench_rate(i, sink.data_ptr(), cyc.data_ptr(),
                                      SMS, threads, iters), mode)
        c = float(cyc.double().mean())
        unit = "bytes" if mode.startswith("lds") else "flop"
        out[mode] = {
            f"{unit}_per_cycle_per_sm":
                work[mode] * iters * (threads // 32) / c,
            "cycles_per_iter": c / iters}
    return out


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bf16 (ties to even), as FP64."""
    return t.to(torch.bfloat16).double()


def routines(cdll, checked: bool, names=ROUTINES,
             entry_fn="product_bench_routine", tp: int = TP) -> dict:
    """Mean cycles per call of each routine over the SMs at a tile of
    ``tp`` points; with ``checked``, also each routine's largest error
    against FP64."""
    gen = torch.Generator().manual_seed(0)
    m = k = WIDTH
    tps = tp + 4
    a = (torch.randn(m * k, generator=gen) * 0.05).cuda()
    b = torch.zeros(k, tps)
    b[:, :tp] = torch.rand(k, tp, generator=gen)
    b2 = torch.zeros(m, tps)
    b2[:, :tp] = torch.randn(m, tp, generator=gen)
    b, b2 = b.cuda(), b2.cuda()
    o = torch.empty(m * tps, device="cuda")
    part = torch.empty(SMS * m * k, device="cuda")
    cyc = torch.zeros(SMS, dtype=torch.int64, device="cuda")
    extra = (tp,) if entry_fn == "product_bench_routine" else ()
    out = {}
    for i, name in enumerate(names):
        rnd = bf16 if name.startswith("bf_") else torch.Tensor.double
        wmat = rnd(a).reshape(m, k)
        bm, b2m = rnd(b[:, :tp]), rnd(b2[:, :tp])
        refs = {"fwd": wmat @ bm, "bwd": wmat.T @ bm, "wgrad": b2m @ bm.T}

        def run(n):
            check(getattr(cdll, entry_fn)(
                i, a.data_ptr(), b.data_ptr(), b2.data_ptr(), o.data_ptr(),
                part.data_ptr(), cyc.data_ptr(), m, k, n, SMS, *extra), name)
        run(1)
        entry = {}
        if checked:
            got = (part[:m * k].reshape(m, k) if name.endswith("wgrad")
                   else o.reshape(m, tps)[:, :tp]).double()
            base = name.removesuffix("_res").split("_")[-1]
            ref = refs[base]
            err = float((got - ref).abs().max() / ref.abs().max())
            if not err <= RTOL:
                raise AssertionError(f"{name} (tp {tp}): error {err} of the "
                                     f"largest output, above {RTOL}")
            entry["max_rel_err"] = err
        run(REPS)
        entry["cycles"] = float(cyc.double().mean()) / REPS
        out[name_at(name, tp)] = entry
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose icnn.cu to bench beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("product_bench needs a CUDA card")
    roots = {"this": ROOT}
    if args.parent is not None:
        roots["parent"] = Path(args.parent).resolve()
    icnn_builds = [(label, "full") for label in roots] + \
        [("this", v) for v in ICNN_VARIANTS if v != "full"]
    with ThreadPoolExecutor(len(VARIANTS) + len(icnn_builds)) as pool:
        icnn_built = {(label, v): pool.submit(build_icnn, label,
                                              roots[label], v)
                      for label, v in icnn_builds}
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
        icnn_built = {k: f.result() for k, f in icnn_built.items()}
    res = {"card": nvidia_smi_line(), "width": WIDTH, "tp": TP,
           "macs_per_call": WIDTH * WIDTH * TP}
    for name, (lib, ptxas) in built.items():
        cdll = load(lib)
        if name == "full":
            res["rates"] = rates(cdll)
        cycles = {}
        for tp in TPS:
            cycles.update(routines(cdll, name == "full", tp=tp))
        res.setdefault("routines", {})[name] = {"cycles": cycles,
                                                "ptxas": ptxas}
    for (label, v), (lib, ptxas, names) in icnn_built.items():
        res.setdefault("icnn_routines", {})[f"{label} {v}"] = {
            "root": str(roots[label]),
            "cycles": routines(load(lib), v == "full", names,
                               "icnn_bench_routine"),
            "ptxas": ptxas}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
