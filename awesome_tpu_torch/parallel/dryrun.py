"""The multi-device dry run; counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``.

    python -m awesome_tpu_torch.parallel.dryrun 4 [--device cpu]

:func:`dryrun_multichip` starts ``n`` ranks (the cards round robin, or the
CPU) on a ``(n // 2, 2)`` mesh (``(n, 1)`` for odd ``n``) and runs, in
each: one full joint step of the flagship (a full-width UNet(4, 1) and the
RealNVP path-connected prior, flow 32 x 12, ICNN 130 x 2) with the images
over 'data' and the grid points over 'grid'; the config-driven protocol
(``mesh_shape`` alone: pretrain -> train -> evaluate); and two epochs of
the FBMS joint loop on a synthetic sequence. Every loss must be finite
and every rank must hold the same one.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch


def mesh_shape_for(n: int) -> Tuple[int, int]:
    """(n // 2, 2) for even n > 1, else (n, 1)."""
    return (n // 2, 2) if n > 1 and n % 2 == 0 else (n, 1)


def _flagship(h: int, w: int, device):
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )
    from awesome_tpu_torch.nn.seg import UNet
    from awesome_tpu_torch.nn.wrapper import WrapperModule

    prior = real_nvp_path_connected_net(
        channels=2, hidden_units=32, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=(h, w), convex_net_hidden_units=130,
        convex_net_hidden_layers=2, device=device)
    return WrapperModule(
        segmentation_module=UNet(in_chn=4, out_chn=1, device=device),
        prior_module=prior, input_mode="image",
        prior_arg_mode="param_clean_grid", seg_stateful=True)


def joint_step_inputs(rows: int, device, h: int = 16, w: int = 16):
    """The dry run's joint step for a mesh of ``rows`` data rows: the
    flagship wrapper on ``device``, its config, a train state and a batch
    of 2 images a row (all made from fixed seeds)."""
    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.fit.trainer import (
        JointTrainConfig,
        joint_train_init,
    )

    batch_size = rows * 2
    wrapper = _flagship(h, w, device)
    cfg = JointTrainConfig(lr=1e-4, prior_lr=1e-3)
    state = joint_train_init(wrapper, torch.Generator().manual_seed(0),
                             batch_size * 2, cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {
        "image": torch.rand((batch_size, h, w, 3), generator=gen
                            ).to(device),
        "features": torch.rand((batch_size, h, w, 1), generator=gen
                               ).to(device),
        "grid": G.flatten_grid(G.pixel_grid((h, w), device=device)),
        "target": (torch.rand((batch_size, h, w, 1), generator=gen)
                   > 0.5).to(torch.float32).to(device),
        "index": torch.arange(batch_size, device=device),
    }
    return wrapper, cfg, state, batch


def _same_on_every_rank(mesh, value: float, what: str) -> None:
    values = mesh.gather_to_root(value)
    if values is not None and len(set(values)) != 1:
        raise RuntimeError(f"dryrun: the ranks disagree on {what}: {values}")
    if not np.isfinite(value):
        raise RuntimeError(f"dryrun: non-finite {what} {value}")


def _shared_tmpdir(mesh) -> str:
    """A directory rank 0 made, named on every rank."""
    import torch.distributed as dist

    name = [tempfile.mkdtemp(prefix="awesome_dryrun_")
            if mesh.is_root else None]
    if mesh.size > 1:
        dist.broadcast_object_list(name, src=mesh.members[0],
                                   group=mesh.group)
    return name[0]


def dryrun_rank(n: int) -> Dict:
    """One rank's part of the dry run (inside the process group): its
    losses, the mesh's backend and this rank's device."""
    import shutil

    from awesome_tpu_torch.data.synthetic import write_synthetic_fbms_sequence
    from awesome_tpu_torch.fit.trainer import make_joint_train_step
    from awesome_tpu_torch.parallel.mesh import make_mesh
    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.runner.fbms_runner import (
        FBMSExperimentConfig,
        FBMSRunner,
    )
    from awesome_tpu_torch.runner.runner import AwesomeRunner

    shape = mesh_shape_for(n)
    mesh = make_mesh(shape)
    dev = mesh.device
    out = {"backend": mesh.backend, "device": str(dev)}

    # one full joint step: images over 'data', grid points over 'grid'
    wrapper, cfg, state, batch = joint_step_inputs(shape[0], dev)
    step = make_joint_train_step(wrapper, cfg, mesh=mesh)
    _, metrics = step(state, batch)
    out["step_loss"] = float(metrics["loss"])
    _same_on_every_rank(mesh, out["step_loss"], "the joint step's loss")
    if mesh.is_root:
        print(f"dryrun_multichip OK: {n} ranks, mesh {shape}, loss "
              f"{out['step_loss']:.5f}", flush=True)

    # the config-driven protocol on the same mesh
    tmp = _shared_tmpdir(mesh)
    try:
        runner = AwesomeRunner(AwesomeConfig(
            name_experiment="dryrun_mesh_protocol",
            dataset_args={"n": max(shape[0], 2), "h": 16, "w": 16},
            segmentation_model_args={"n_hidden": 16},
            prior_model_args={"n_hidden": 12, "n_hidden_layers": 1},
            optimizer_type="adam", optimizer_args={"lr": 0.02},
            num_epochs=20, pretrain_args={"num_epochs": 20},
            runs_path=os.path.join(tmp, "runs"), seed=5,
            mesh_shape=list(shape), device=str(dev)))
        runner.build()
        if runner.mesh is None or tuple(runner.mesh.shape.values()) != shape:
            raise RuntimeError(f"dryrun: the runner's mesh {runner.mesh}")
        runner.pretrain()
        result = runner.train()
        out["protocol_loss"] = float(np.asarray(
            result["loss_hist"])[:, -1].mean())
        out["protocol_miou"] = runner.evaluate()["MeanForegroundBinaryMIOU"]
        _same_on_every_rank(mesh, out["protocol_loss"],
                            "the protocol's loss")
        if mesh.is_root:
            print(f"dryrun_multichip protocol OK: pretrain+train+eval on "
                  f"mesh {shape}, final loss {out['protocol_loss']:.5f}, "
                  f"miou {out['protocol_miou']:.3f}", flush=True)

        # the FBMS joint loop on the same mesh
        seq = os.path.join(tmp, "fbms")
        if mesh.is_root:
            seq = write_synthetic_fbms_sequence(seq)
        seq = _broadcast(mesh, seq)
        fr = FBMSRunner(FBMSExperimentConfig(
            dataset_path=seq, prior_hidden_units=8, prior_flows=2,
            convex_hidden_units=12, convex_hidden_layers=1,
            mesh_shape=list(shape)), device=dev).build()
        res = fr.train_joint(num_epochs=2, batch_size=2, lr=1e-3,
                             prior_lr=1e-3, eval_nth_epoch=2)
        out["fbms_loss"] = float(np.mean(res["loss"]))
        _same_on_every_rank(mesh, out["fbms_loss"], "the FBMS joint loss")
        if mesh.is_root:
            print(f"dryrun_multichip FBMS joint OK: train_joint on mesh "
                  f"{shape}, mean loss {out['fbms_loss']:.5f}", flush=True)
    finally:
        mesh.barrier()
        if mesh.is_root:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def _broadcast(mesh, value):
    import torch.distributed as dist

    box = [value]
    if mesh.size > 1:
        dist.broadcast_object_list(box, src=mesh.members[0],
                                   group=mesh.group)
    return box[0]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict:
    """Start ``n_devices`` ranks on ``device`` and run :func:`dryrun_rank`
    in each; returns rank 0's losses and, under ``ranks``, every rank's
    backend and device. Raises if a rank fails."""
    from awesome_tpu_torch.parallel.launch import spawn

    results = spawn(dryrun_rank, n_devices, (n_devices,), device=device)
    where = [{k: r.pop(k) for k in ("backend", "device")} for r in results]
    return dict(results[0], ranks=where)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args()
    print(dryrun_multichip(a.n, a.device))
