"""The plain reference: Neural ADMIXTURE's training step, Adam and Q pass
in plain PyTorch, written from the model's equations. It imports nothing
of the program under test.

  X (B, M) = genotype / 2, missing -> 0
  Xp = X @ V;  e = relu(rmsnorm(Xp) @ W_c + b_c)
  q_k = softmax(e @ W_k + b_k)                       one head per K
  loss = sum_k BCE(clamp(q_k @ P_k, 0, 1), X)       summed, torch's BCE
  Adam (betas, eps) on every parameter, V included; then P_k clamped to
  [0, 1]

:func:`train_steps` follows the first steps from the initial weights;
:func:`replay_step` follows one step from a given state (the parameters,
Adam's moments and its step count), for steps deep inside a run that no
reference could reach step by step in the time a run has.

The loss and its gradients come from autograd over SNP chunks (the loss is
a sum over SNPs, so the chunks' gradients add up to the whole one), so a
full-width batch never holds its (B, M) planes at once. Matrix products
run in fp32 with TF32 off unless ``tf32`` is set: that is the control, the
same arithmetic one precision step below the configuration's.
"""
from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

RMSNORM_EPS = 1e-8


@contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """fp32 matrix products, or TF32 ones for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def flatten(tree: Dict, prefix: str = "") -> Dict[str, object]:
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def to_device(params: Dict, device) -> Dict[str, torch.Tensor]:
    """The flattened parameter dict as fp32 tensors on ``device``, copies
    (the caller's arrays are never written)."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in flatten(params).items()}


def heads(p: Dict[str, torch.Tensor]) -> List[str]:
    """Head keys, ascending K."""
    return sorted((k.split("/")[1] for k in p if k.startswith("decoders/")),
                  key=lambda hk: int(hk[1:]))


def dosage(packed: torch.Tensor) -> torch.Tensor:
    """(R, w) uint8 packed bytes -> (R, 4 w) fp32 genotype / 2, missing
    (code 3) and padding -> 0."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    g = ((packed.unsqueeze(-1) >> shifts) & 3).reshape(packed.shape[0], -1)
    return g.to(torch.float32).masked_fill_(g == 3, 0.0) * 0.5


def project(packed: torch.Tensor, V: torch.Tensor, chunk: int
            ) -> torch.Tensor:
    """Xp = X @ V over SNP chunks of ``chunk`` (a multiple of 4)."""
    Xp = torch.zeros(packed.shape[0], V.shape[1], device=V.device)
    for c0 in range(0, V.shape[0], chunk):
        x = dosage(packed[:, c0 // 4:(c0 + chunk) // 4])
        Xp += x @ V[c0:c0 + x.shape[1]]
    return Xp


def encode(p: Dict[str, torch.Tensor], Xp: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """{head: q (B, k)} from Xp."""
    z = Xp * torch.rsqrt(Xp.pow(2).mean(-1, keepdim=True) + RMSNORM_EPS)
    e = torch.relu((z * p["rmsnorm/weight"]) @ p["common/kernel"]
                   + p["common/bias"])
    return {hk: torch.softmax(e @ p[f"heads/{hk}/kernel"]
                              + p[f"heads/{hk}/bias"], dim=-1)
            for hk in heads(p)}


def loss_and_grads(p: Dict[str, torch.Tensor], packed: torch.Tensor,
                   M: int, chunk: int) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(the batch's loss, {leaf: gradient}) for packed rows (B, W) on the
    device; M real SNPs."""
    Xp = project(packed, p["V"], chunk).requires_grad_()
    enc = {k: v.detach().requires_grad_() for k, v in p.items()
           if not k.startswith(("V", "decoders/"))}
    qs = encode({**p, **enc}, Xp)
    q_leaf = {hk: q.detach().requires_grad_() for hk, q in qs.items()}
    grads = {f"decoders/{hk}": torch.zeros_like(p[f"decoders/{hk}"])
             for hk in qs}
    loss = torch.zeros((), dtype=torch.float64, device=Xp.device)
    for c0 in range(0, M, chunk):
        c1 = min(M, c0 + chunk)
        x = dosage(packed[:, c0 // 4:-(-c1 // 4)])[:, :c1 - c0]
        for hk, q in q_leaf.items():
            Pc = p[f"decoders/{hk}"][:, c0:c1].detach().requires_grad_()
            term = F.binary_cross_entropy(torch.clamp(q @ Pc, 0.0, 1.0), x,
                                          reduction="sum")
            term.backward()
            loss += term.detach().double()
            grads[f"decoders/{hk}"][:, c0:c1] = Pc.grad
    torch.autograd.backward([qs[hk] for hk in q_leaf],
                            [q_leaf[hk].grad for hk in q_leaf])
    grads.update({k: v.grad for k, v in enc.items()})
    dXp = Xp.grad
    dV = torch.zeros_like(p["V"])
    for c0 in range(0, dV.shape[0], chunk):
        x = dosage(packed[:, c0 // 4:(c0 + chunk) // 4])
        dV[c0:c0 + x.shape[1]] = x.T @ dXp
    grads["V"] = dV
    return float(loss), grads


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def adam_step(p: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor],
              v2: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
              t: int, lr: float, betas: Tuple[float, float], eps: float
              ) -> None:
    """Adam's step ``t`` (from 1) on every leaf in place, then each P
    clamped to [0, 1]."""
    b1, b2 = betas
    for k in p:
        m[k].mul_(b1).add_(g[k], alpha=1 - b1)
        v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
        denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
        p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        if k.startswith("decoders/"):
            p[k].clamp_(0.0, 1.0)


def train_steps(params: Dict, batches: List[torch.Tensor], M: int,
                lr: float, betas: Tuple[float, float], eps: float,
                chunk: int, tf32: bool = False) -> Dict:
    """Adam over ``batches`` (packed rows on the device), from ``params``
    (the layout dict). Returns {"loss": [each step's loss], "grad": {leaf:
    step 1's gradient norm}, "change": {leaf: the norm of the parameter's
    change over the steps}}."""
    device = batches[0].device
    with precision(tf32), torch.no_grad():
        p = to_device(params, device)
        p0 = {k: v.clone() for k, v in p.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, grad1 = [], None
        for t, packed in enumerate(batches, start=1):
            with torch.enable_grad():
                loss, g = loss_and_grads(p, packed, M, chunk)
            losses.append(loss)
            if grad1 is None:
                grad1 = {k: _norm(x) for k, x in g.items()}
            adam_step(p, m, v2, g, t, lr, betas, eps)
            del g
        change = {k: _norm(p[k] - p0[k]) for k in p}
    return {"loss": losses, "grad": grad1, "change": change}


def replay_step(state: Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]], t: int,
                packed: torch.Tensor, M: int, lr: float,
                betas: Tuple[float, float], eps: float, chunk: int,
                tf32: bool = False, scale: float = 1.0) -> Dict:
    """Adam's step ``t`` (from 1) from ``state`` = {leaf: (parameter,
    exp_avg, exp_avg_sq)} in the layout's orientation (never written) on
    the batch ``packed``. ``scale`` multiplies the loss and the gradient
    (the control's half batch reads 2). Returns {"loss": [the loss at the
    state], "grad": {leaf: the gradient's norm}, "change": {leaf: the norm
    of the step's change, after the clamp}}."""
    with precision(tf32), torch.no_grad():
        p = {k: s[0].float().clone() for k, s in state.items()}
        with torch.enable_grad():
            loss, g = loss_and_grads(p, packed, M, chunk)
        g = {k: x * scale for k, x in g.items()}
        grad = {k: _norm(x) for k, x in g.items()}
        m = {k: s[1].float().clone() for k, s in state.items()}
        v2 = {k: s[2].float().clone() for k, s in state.items()}
        adam_step(p, m, v2, g, t, lr, betas, eps)
        del g, m, v2
        change = {k: _norm(p[k] - state[k][0]) for k in p}
    return {"loss": [loss * scale], "grad": grad, "change": change}


def q_pass(params: Dict, packed: np.ndarray, device, chunk: int,
           block_rows: int = 4096, tf32: bool = False
           ) -> Dict[str, np.ndarray]:
    """{head: Q (N, k)} of every host row of ``packed``, in row order."""
    out: Dict[str, List[np.ndarray]] = {}
    with precision(tf32), torch.no_grad():
        p = to_device(params, device)
        for r0 in range(0, packed.shape[0], block_rows):
            rows = torch.from_numpy(packed[r0:r0 + block_rows]).to(device)
            for hk, q in encode(p, project(rows, p["V"], chunk)).items():
                out.setdefault(hk, []).append(q.cpu().numpy())
    return {hk: np.concatenate(v) for hk, v in out.items()}
