"""The train state and the train step: the gradient of ``lm_loss`` through
the executors and the kernels' autograd Functions, microbatch gradient
accumulation, non-finite step skipping on the device, and the AdamW
update."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.blocks import MAMBA_TYPES
from repro_torch.models.model import init_params, lm_loss
from repro_torch.optim import OptimConfig, adamw_init, adamw_update
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def check_trainable(cfg: ArchConfig) -> None:
    """The port trains the dense ARMT family (the attn block with a dense
    FFN, with or without QKV bias, q/k norm, partial rotary); it has no
    backward yet for mamba_scan, the MoE dispatch or the encoder."""
    types = set(cfg.layer_types)
    if types & set(MAMBA_TYPES):
        raise ValueError(f"{cfg.name}: training has no mamba layers yet (no mamba_scan "
                         "backward)")
    if cfg.moe is not None or "attn_moe" in types:
        raise ValueError(f"{cfg.name}: training has no MoE FFN yet")
    if cfg.encoder is not None:
        raise ValueError(f"{cfg.name}: training has no encoder yet")


def init_train_state(cfg: ArchConfig, ocfg: OptimConfig, generator, device=None) -> Dict:
    """{"params": init_params(cfg, generator, device=device), "opt":
    adamw_init(...)}; device None means the card (it raises without one)."""
    params = init_params(cfg, generator, device=device)
    return {"params": params, "opt": adamw_init(params, ocfg)}


def make_train_step(cfg: ArchConfig, ocfg: OptimConfig, *, schedule: str = "auto",
                    mode: str = "segmented", microbatches: int = 1,
                    skip_nonfinite: bool = True, fused: bool = True):
    """train_step(state, batch) -> (new state, metrics). batch: tensors
    "tokens" and "labels" [B, S*seg_len], optionally "loss_mask"; B is split
    into ``microbatches`` equal parts whose fp32 gradients are summed and
    divided by their count (one part: the gradients in the param dtype, as
    the reference). metrics: "loss", "lr", "grad_norm" (before clipping)
    and, with skip_nonfinite, "skipped" (1.0 where the loss or the norm was
    not finite: the state then comes back unchanged, chosen on the device
    by ``torch.where`` on every leaf, with no host read), all 0-d tensors.
    The state passed in is not modified. fused: the kernels (False: the
    plain path)."""
    check_trainable(cfg)
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")

    def batch_loss(params, batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"], schedule=schedule,
                       mode=mode, loss_mask=batch.get("loss_mask"), fused=fused)

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
        loss, grads = grads_of(state["params"], batch)
        new_params, new_opt, metrics = adamw_update(state["params"], grads, state["opt"], ocfg)
        if skip_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(metrics["grad_norm"])

            def keep(new, old):
                return torch.where(ok, new, old)
            new_params = tree_map(keep, new_params, state["params"])
            new_opt = tree_map(keep, new_opt, state["opt"])
            metrics["skipped"] = (~ok).float()
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
