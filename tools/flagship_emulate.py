"""The flagship kernel's FP32 build run on the CPU, for its logic.

    python3 -m tools.flagship_emulate

There is no CUDA compiler on a machine without a card, yet the kernel's
arithmetic can be checked there: this compiles
``awesome_tpu_torch/ops/csrc/flagship.cu`` with g++ against the small CUDA
emulation in ``tools/csrc/emu/`` (one std::thread per CUDA thread, barriers
for ``__syncthreads`` and a warp's shuffles; inline PTX, so the bf16
build's ``mma.sync``, is not emulated), into ``build/emu/``, runs it block
by block on seeded inputs (``chip_smoke.loss_grad_inputs``) and holds it
to the plain version at the kernel's tolerances (loss rtol 1e-5, grads
rtol 5e-4 atol 1e-6), or, where it is past them, to a float64 run of the
plain version: no farther from it than the plain FP32 version is (a relu
decision at a point whose pre-activation rounds to either side of 0 moves
the plain version too). The cases cover both tile instantiations, flows
whose 2H the lanes do not divide, odd flow counts, one and two term
buffers, per-image points and no tanh. Last it runs the inputs of
``tests/test_torch_kernel_gpu.py::test_cuda_k2_sixteen_images_match_plain``
and prints the emulated kernel's and the plain FP32 version's largest
errors against a float64 run of the plain version. It prints one JSON line
per case and exits nonzero if a case fails. About two minutes in all; a
race or a timing the card has is not reproduced here.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tools" / "csrc" / "emu"
OUT = ROOT / "build" / "emu"
# (ICNN width, layers, points per chunk, N, G, flow hidden, flows,
#  per-image points, tanh)
CASES = ((130, 2, 64, 300, 2, 32, 12, False, True),
         (130, 3, 32, 300, 2, 32, 12, False, True),
         (40, 2, 64, 200, 2, 7, 5, False, True),
         (40, 1, 32, 150, 1, 13, 3, False, True),
         (50, 2, 64, 257, 3, 32, 12, True, False),
         (130, 2, 64, 300, 2, 130, 6, False, True),
         (130, 3, 32, 200, 2, 130, 3, False, True))
CHUNKS = 3  # chunks per block: several chunks per block, several blocks


def build() -> Path:
    """kernel.cc (flagship.cu without its inline PTX and launch syntax),
    then the harness."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "awesome_tpu_torch" / "ops" / "csrc" /
           "flagship.cu").read_text()
    src = re.sub(r"<<<[^>]*>>>", " ", src)
    src = re.sub(r"asm volatile\((.*?)\);", "{}", src, flags=re.S)
    (OUT / "kernel.cc").write_text(src)
    exe = OUT / "harness"
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                    "-pthread", "-w", f"-I{EMU}", f"-I{OUT}", "-o", str(exe),
                    str(EMU / "harness.cc")], check=True)
    return exe


def emulate(exe: Path, spec, flat, x, tgt, wts, tp: int) -> np.ndarray:
    """(G, P + 1): the emulated kernel's grads, then each image's loss."""
    from awesome_tpu_torch.ops import flagship as F

    g, n = tgt.shape
    off, p_len = spec.offsets()
    n_chunks = -(-n // tp)
    hdr = np.zeros(32, np.int32)
    hdr[:13] = [n, g, int(x.ndim == 3), spec.n_flows, spec.hidden,
                spec.icnn_w, spec.n_layers, int(spec.use_tanh), 1, tp,
                CHUNKS, -(-n_chunks // CHUNKS), p_len]
    hdr[13:29] = [off[k] for k in F.PACKED_FIELDS]
    consts = np.concatenate([spec.pre_a.ravel(), spec.pre_b.ravel(),
                             spec.post_a.ravel(), spec.post_b.ravel()])
    with open(OUT / "in.bin", "wb") as f:
        for a in (hdr, consts.astype(np.float32), x, tgt, wts, flat):
            f.write(np.ascontiguousarray(np.asarray(a)).tobytes())
    subprocess.run([str(exe), str(OUT / "in.bin"), str(OUT / "out.bin")],
                   check=True)
    return np.fromfile(OUT / "out.bin", np.float32).reshape(g, p_len + 1)


def float64_grads(spec, flat, x, tgt, wts) -> np.ndarray:
    """(G, P): the plain version's grads in float64."""
    from awesome_tpu_torch.ops import flagship as F

    packed = {k: v.double() for k, v in F.unpack_flat(spec, flat).items()}
    _, ref = F.flagship_loss_grad_plain(spec, packed, x.double(),
                                        tgt.double(), wts.double())
    return F.pack_flat(ref, flat.shape[0]).numpy()


def model_of(width, layers, hidden, flows, tanh):
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    return real_nvp_path_connected_net(
        channels=2, hidden_units=hidden, flow_n_flows=flows,
        flow_output_fn="tanh" if tanh else None, spatial_shape=(64, 64),
        convex_net_hidden_units=width, convex_net_hidden_layers=layers,
        device="cpu")


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, loss_grad_inputs
    from awesome_tpu_torch.ops import flagship as F

    exe = build()
    ok = True
    for seed, (width, layers, tp, n, g, hidden, flows, per_image,
               tanh) in enumerate(CASES):
        model = model_of(width, layers, hidden, flows, tanh)
        spec, flat, x, tgt, wts = loss_grad_inputs(model, n, g, seed, "cpu",
                                                   per_image)
        out = emulate(exe, spec, flat, x, tgt, wts, tp)
        _, p_len = spec.offsets()
        loss, grads = F.flagship_loss_grad_plain(
            spec, F.unpack_flat(spec, flat), x, tgt, wts)
        grads = F.pack_flat(grads, g).numpy()
        close = bool(np.allclose(out[:, p_len], loss.numpy(),
                                 rtol=LOSS_RTOL, atol=0.0)
                     and np.allclose(out[:, :p_len], grads, rtol=GRAD_RTOL,
                                     atol=GRAD_ATOL))
        ref = float64_grads(spec, flat, x, tgt, wts)
        emu_err = float(np.abs(out[:, :p_len] - ref).max())
        plain_err = float(np.abs(grads - ref).max())
        # past the tolerance only where the plain FP32 version is itself
        # farther from float64 than the kernel (a relu decision near 0)
        good = close or emu_err <= plain_err
        ok &= good
        print(json.dumps({"width": width, "layers": layers, "tp": tp, "n": n,
                          "g": g, "hidden": hidden, "flows": flows,
                          "per_image": per_image, "tanh": tanh, "ok": good,
                          "within_tolerance_of_plain": close,
                          "max_abs_err": float(np.abs(
                              out[:, :p_len] - grads).max()),
                          "emulated_max_err_vs_float64": emu_err,
                          "plain_fp32_max_err_vs_float64": plain_err}),
              flush=True)
    # the inputs of the GPU test at G = 16, and a float64 run of the plain
    # version: which of the two FP32 results is nearer it
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_kernel_gpu import _flagship_inputs

    spec, stacked, flat, x, tgt, wts = _flagship_inputs("cpu", 130, 2, 16,
                                                        g=16, n=64 * 64)
    out = emulate(exe, spec, flat, x, tgt, wts, 64)[:, :-1]
    _, plain = F.flagship_loss_grad_plain(spec, stacked, x, tgt, wts)
    plain = F.pack_flat(plain, 16).numpy()
    ref = float64_grads(spec, flat, x, tgt, wts)
    print(json.dumps({"case": "G=16 64x64 (the GPU test's inputs)",
                      "emulated_max_err_vs_float64": float(
                          np.abs(out - ref).max()),
                      "plain_fp32_max_err_vs_float64": float(
                          np.abs(plain - ref).max())}), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
