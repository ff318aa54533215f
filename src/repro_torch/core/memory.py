"""ARMT associative memory (paper eqs. 3-6).

Per layer the memory is A in R^{d_phi x d_val} and a normalizer z in
R^{d_phi}, d_phi = 2*nu*d_mem (DPFP-nu feature map). Once per segment:

  read (eq 6):   AssociativeLayer(x) = A phi(W_Q x) / (z^T phi(W_Q x))
  update (3-5):  k,v = W_K m, W_V m;  beta = sigmoid(W_beta m)
                 vbar  = A phi(k) / (z^T phi(k))
                 gamma = 1 - z^T phi(k) / ||phi(k)||^2
                 A <- A + sum_i beta_i (v_i - vbar_i) (x) phi(k_i)
                 z <- z + sum_i gamma_i phi(k_i)

State is float32 whatever the model dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import ARMTConfig

EPS = 1e-6

# The per-layer recurrent state leaves; KV caches are segment-local and
# empty at a segment boundary, so these are all a boundary snapshot needs.
RECURRENT_KEYS = ("A", "z", "h", "conv")


def recurrent_state(state: Dict) -> Dict:
    """Project an executor/decode state tree onto its recurrent leaves."""
    def keep(d: Dict) -> Dict:
        return {k: d[k] for k in RECURRENT_KEYS if k in d}
    return {"prelude": tuple(keep(d) for d in state["prelude"]),
            "pattern": tuple(keep(d) for d in state["pattern"])}


def dpfp(x: torch.Tensor, nu: int = 3) -> torch.Tensor:
    """Deterministic Parameter-Free Projection: [..., d] -> [..., 2*nu*d]."""
    r = torch.cat([torch.relu(x), torch.relu(-x)], dim=-1)
    return torch.cat([r * torch.roll(r, shifts=j, dims=-1)
                      for j in range(1, nu + 1)], dim=-1)


def d_phi(acfg: ARMTConfig) -> int:
    return 2 * acfg.nu * acfg.d_mem


def mem_state_init(batch: int, d_model: int, acfg: ARMTConfig,
                   device) -> Dict[str, torch.Tensor]:
    """Zero state (eq 3: A_0 = 0, z_0 = 0), float32."""
    d_val = acfg.d_val or d_model
    return {"A": torch.zeros(batch, d_phi(acfg), d_val, device=device),
            "z": torch.zeros(batch, d_phi(acfg), device=device)}


def mem_read(params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
             x: torch.Tensor, acfg: ARMTConfig) -> torch.Tensor:
    """Associative read (eq 6). x: [B, T, D] -> [B, T, d_val] (fp32 math)."""
    q = torch.matmul(x.float(), params["wq"].float())
    pq = dpfp(q, acfg.nu)                                        # [B,T,P]
    num = torch.matmul(pq, state["A"])
    den = torch.einsum("btp,bp->bt", pq, state["z"]) + EPS
    return (num / den[..., None]).to(x.dtype)


def mem_update(params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
               m: torch.Tensor, acfg: ARMTConfig) -> Dict[str, torch.Tensor]:
    """Delta-rule update (eqs 3-5). m: [B, M, D] memory-token layer outputs."""
    m32 = m.float()
    k = torch.matmul(m32, params["wk"].float())
    v = torch.matmul(m32, params["wv"].float())
    beta = torch.sigmoid(torch.matmul(m32, params["wb"].float()))[..., 0]
    pk = dpfp(k, acfg.nu)                                        # [B,M,P]
    zk = torch.einsum("bmp,bp->bm", pk, state["z"])
    vbar = torch.matmul(pk, state["A"]) / (zk + EPS)[..., None]
    gamma = 1.0 - zk / ((pk * pk).sum(-1) + EPS)
    A_new = state["A"] + torch.matmul(pk.transpose(1, 2),
                                      beta[..., None] * (v - vbar))
    z_new = state["z"] + torch.einsum("bm,bmp->bp", gamma, pk)
    return {"A": A_new, "z": z_new}
