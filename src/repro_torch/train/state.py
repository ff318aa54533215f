"""The train state and the train step: the gradient of ``lm_loss`` through
the executors and the kernels' autograd Functions, microbatch gradient
accumulation, non-finite step skipping on the device, and the AdamW
update.

On a mesh (``make_train_step(..., mesh=)``, the reference's ``train_4k``
cell: params by ``param_specs``, the optimizer state by
``opt_state_specs(zero1=True)``, the batch by ``batch_specs``) the step
runs on a rank's local view of the state (``train_specs``): the params
cut over 'model' as ``models/model.py`` ``shard_model`` cuts them, the
moments also cut over the DP axes (ZeRO-1). The forward and backward run
inside the tensor-parallel context on the rank's rows
(``data/loader.py`` ``shard_batch``); the gradients are summed over the
DP axes in a few flat buckets a dtype (``comm.all_reduce_buckets``); the
AdamW update runs on the rank's ZeRO-1 blocks and all-gathers the params
(``optim/adamw.py``). The metrics are replicated: the loss summed over
the DP axes, the norm over 'model' where a leaf is cut, so every rank
decides ``skipped`` on the same values.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.model import (init_params, lm_loss, local_config, local_param_specs,
                                      mesh_family, tensor_parallel)
from repro_torch.models.moe import check_dispatch
from repro_torch.optim import OptimConfig, adamw_init, adamw_update
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def check_trainable(cfg: ArchConfig) -> None:
    """The port trains every config the reference trains: the dense ARMT
    family, the MoE configs, the Mamba layers (pure, and in jamba's hybrid
    pattern) and the encoder-decoder. It refuses only what it has not
    ported: the MoE's ``einsum`` dispatch."""
    if cfg.moe is not None:
        check_dispatch(cfg.moe)


def init_train_state(cfg: ArchConfig, ocfg: OptimConfig, generator, device=None) -> Dict:
    """{"params": init_params(cfg, generator, device=device), "opt":
    adamw_init(...)}; device None means the card (it raises without one)."""
    params = init_params(cfg, generator, device=device)
    return {"params": params, "opt": adamw_init(params, ocfg)}


def train_state_specs(cfg: ArchConfig, ocfg: OptimConfig) -> Dict:
    """The train state's shapes and dtypes without allocation:
    ``init_train_state`` on the meta device."""
    return init_train_state(cfg, ocfg, 0, device="meta")


def check_mesh_trainable(cfg: ArchConfig, ocfg: OptimConfig, mesh, fsdp: bool) -> None:
    """What training on a mesh refuses: a 'stage' axis of more than one rank
    (the reference trains on none: its train cell shards no stacked dim),
    ZeRO-3 (``fsdp``), configs outside the dense ARMT family, and a
    factored second moment on a 'model' axis."""
    if fsdp:
        raise ValueError("fsdp=True (the params cut over the DP axes too): not ported; it "
                         "comes with launch/specs.py, which chooses it (ROADMAP Queue 1 "
                         "item 10)")
    if shd.stage_size(mesh) > 1:
        raise ValueError(f"mesh {mesh.shape}: training on a 'stage' axis: the reference "
                         "trains on no stage axis (its train cell shards no stacked dim), "
                         "and neither does the port")
    if not mesh_family(cfg):
        raise ValueError(f"{cfg.name} on a mesh: training on a mesh runs the dense ARMT "
                         "family only; MoE, Mamba, hybrid and encoder configs wait in "
                         "ROADMAP Queue 1 item 8")
    if ocfg.factored_v and shd.tp_size(mesh) > 1:
        raise ValueError("factored_v on a 'model' axis: the factored moment's statistics "
                         "of a leaf cut over the axis are not ported")


def train_specs(cfg: ArchConfig, ocfg: OptimConfig, mesh, *, zero1: bool = True) -> Dict:
    """The ``Sharding`` tree of a rank's local view of the train state:
    {"params": ``local_param_specs``, "opt": ``opt_state_specs`` following
    them (ZeRO-1: the moments' first replicated dim that the DP size
    divides also cut over the DP axes; zero1=False: as the params)}.
    ``comm.shard_tree`` cuts a whole state by it, ``comm.gather_tree``
    makes it whole again (the checkpoints)."""
    shapes = train_state_specs(cfg, ocfg)
    pspecs = local_param_specs(shapes["params"], mesh)
    return {"params": pspecs, "opt": shd.opt_state_specs(
        shapes["opt"], shapes["params"], mesh, zero1=zero1, pspecs=pspecs)}


def make_train_step(cfg: ArchConfig, ocfg: OptimConfig, *, schedule: str = "auto",
                    mode: str = "segmented", microbatches: int = 1,
                    skip_nonfinite: bool = True, fused: bool = True, mesh=None,
                    zero1: bool = True, fsdp: bool = False):
    """train_step(state, batch) -> (new state, metrics). batch: tensors
    "tokens" and "labels" [B, S*seg_len], optionally "loss_mask", and for an
    encoder-decoder (whisper) "enc_frames" [B, F, D], as the reference's
    batch carries them; B is split into ``microbatches`` equal parts whose
    fp32 gradients are summed and divided by their count (one part: the
    gradients in the param dtype, as the reference). metrics: "loss", "lr",
    "grad_norm" (before clipping) and, with skip_nonfinite, "skipped" (1.0
    where the loss or the norm was not finite: the state then comes back
    unchanged, chosen on the device by ``torch.where`` on every leaf, into
    the new leaf, with no host read), all 0-d tensors. The state passed in is not modified.
    fused: the kernels (False: the plain path).

    mesh: train on a ``launch.mesh.Mesh`` (the module's docstring): the
    state is a rank's local view (``train_specs``; zero1=False keeps the
    moments whole over the DP axes), the batch the rank's rows
    (``shard_batch(..., microbatches=)``), every rank making the same
    calls; the new state is local, the metrics replicated. A one-rank
    mesh gives the mesh-less step's bits. Refused: ``check_mesh_trainable``."""
    check_trainable(cfg)
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")
    specs, tp, dp = None, None, ()
    if mesh is not None:
        check_mesh_trainable(cfg, ocfg, mesh, fsdp)
        specs = train_specs(cfg, ocfg, mesh, zero1=zero1)
        tp, dp = tensor_parallel(specs["params"], mesh), shd.dp_axes(mesh)
        cfg = local_config(cfg, shd.tp_size(mesh))

    def batch_loss(params, batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"], schedule=schedule,
                       mode=mode, loss_mask=batch.get("loss_mask"), fused=fused,
                       enc_frames=batch.get("enc_frames"), mesh=mesh)

    def loss_and_grads(params, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.enable_grad():
            loss = batch_loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def grads_of(params, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(params, batch)
            return loss, tree_unflatten(params, grads)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
        n = B // microbatches
        loss_sum, acc = 0.0, None
        for i in range(microbatches):
            loss, grads = loss_and_grads(params, {k: v[i * n:(i + 1) * n]
                                                  for k, v in batch.items()})
            loss_sum = loss_sum + loss
            acc = ([g.float() for g in grads] if acc is None
                   else [a + g.float() for a, g in zip(acc, grads)])
        return loss_sum / microbatches, tree_unflatten(params, [a / microbatches for a in acc])

    def train_step(state: Dict, batch: Dict):
        with comm.parallel(tp) if mesh is not None else contextlib.nullcontext():
            loss, grads = grads_of(state["params"], batch)
        if mesh is not None:
            grads = tree_unflatten(grads, comm.all_reduce_buckets(tree_leaves(grads), mesh, dp))
            loss = comm.all_reduce(loss, mesh, dp)
        new_params, new_opt, metrics = adamw_update(state["params"], grads, state["opt"], ocfg,
                                                    mesh=mesh, specs=specs)
        if skip_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(metrics["grad_norm"])

            def keep(new, old):
                # into the new state's own tensors, so that no third copy of
                # the state is live (adamw_update returns new tensors)
                return torch.where(ok, new, old, out=new)
            new_params = tree_map(keep, new_params, state["params"])
            new_opt = tree_map(keep, new_opt, state["opt"])
            metrics["skipped"] = (~ok).float()
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
