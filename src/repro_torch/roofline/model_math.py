"""Analytic parameter counts and the model's useful FLOPs (6*N*D to train,
2*N*D to infer; N the parameters active per token, for a MoE the routed
experts' top_k of n_experts), counted over ``param_specs`` on the meta
device, so a 1 T-parameter config costs no memory. The reference's rules,
to the element: a routed expert weight is a ``wg``/``wu``/``wd`` leaf under
a ``moe`` key (the shared expert's too, as there)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.models.model import param_specs
from repro_torch.utils import tree_flatten_with_path, tree_params


def param_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(total parameters, parameters active per token)."""
    shapes = param_specs(cfg)
    total = tree_params(shapes)
    active = total
    if cfg.moe is not None:
        routed = sum(leaf.numel() for path, leaf in tree_flatten_with_path(shapes)
                     if "moe" in path.split("/") and path.split("/")[-1] in ("wg", "wu", "wd"))
        active = total - routed + int(routed * cfg.moe.top_k / cfg.moe.n_experts)
    return total, active


def embedding_params(cfg: ArchConfig) -> int:
    n = cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n *= 2
    return n


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Useful model FLOPs of one step of this shape (the whole job):

    train:   6 * N_active * tokens   (forward 2ND + backward 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch    (one token per sequence)

    The embedding table is left out of N (a lookup, not a product); the
    output projection is in it."""
    _, active = param_counts(cfg)
    n = active - cfg.vocab * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch
