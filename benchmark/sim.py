"""The benchmark's inputs, made from the seed: a simulated admixed panel,
2-bit packed as the port's readers pack it, and the model's initial
weights.

The panel follows the admixture model that ADMIXTURE and Neural ADMIXTURE
fit. Per SNP an ancestral frequency p ~ U(lo, hi), and per population a
frequency drawn around it with variance F p (1 - p) (the Balding-Nichols
model, in its normal approximation, clipped into (0, 1)). Per sample the
proportions Q* ~ Dirichlet(alpha) over the populations. A genotype is
g ~ Binomial(2, Q* P*^T), and a share of codes is missing, uniformly.

Codes 0, 1, 2 count alleles and 3 is missing; SNP j of a row sits at bits
2 (j % 4) of byte j // 4, and the SNP axis is padded with code 0 to a
multiple of ``pad_snps_to`` (the port's readers pad to 2048). Everything
is drawn on ``device`` from generators seeded by the seed, in row blocks.

The weights stand in for what the CLI computes before training: V is an
orthonormal basis of the span of P* (the top right singular vectors of the
uncentred codes, which the RSVD finds, lie there); each head's P starts at
mixtures of the populations' frequencies (where the GMM's cluster means
land), clipped into [5e-6, 1 - 5e-6] as the CLI clips them; the linears
are drawn as torch.nn.Linear draws them. The dict has the layout that
``launch_training`` takes (kernels (in, out), decoders (k, m_pad)).
"""
from typing import Dict, Tuple

import numpy as np
import torch

P_CLIP = 5e-6


def generator(device, seed: int, *tags: int) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws, seeded
    from (seed, *tags) through numpy's SeedSequence."""
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def padded_snps(traffic: Dict) -> int:
    q = int(traffic["pad_snps_to"])
    return -(-int(traffic["snps"]) // q) * q


def pack_codes(codes: torch.Tensor, m_pad: int) -> torch.Tensor:
    """(R, M) uint8 codes -> (R, m_pad / 4) uint8 packed rows, the SNP axis
    padded with code 0."""
    R, M = codes.shape
    full = torch.zeros(R, m_pad, dtype=torch.uint8, device=codes.device)
    full[:, :M] = codes
    v = full.view(R, m_pad // 4, 4)
    return v[..., 0] | (v[..., 1] << 2) | (v[..., 2] << 4) | (v[..., 3] << 6)


def _dirichlet(gen: torch.Generator, n: int, k: int, alpha: float,
               device) -> torch.Tensor:
    """(n, k) rows ~ Dirichlet(alpha), alpha a multiple of 1/2: Gamma(m/2)
    is half a chi-square of m normals."""
    m = 2 * alpha
    if m != int(m) or m < 1:
        raise ValueError(f"dirichlet_alpha must be a multiple of 0.5, got "
                         f"{alpha}")
    z = torch.randn(int(m), n, k, generator=gen, device=device)
    g = (z * z).sum(0)
    return g / g.sum(1, keepdim=True)


def truth(traffic: Dict, seed: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(P* (M, K*), Q* (N, K*)) fp32 on ``device``."""
    gen = generator(device, seed, 1)
    M, N = int(traffic["snps"]), int(traffic["samples"])
    K = int(traffic["populations"])
    lo, hi = traffic["ancestral_freq"]
    F = float(traffic["fst"])
    p = lo + (hi - lo) * torch.rand(M, generator=gen, device=device)
    sd = torch.sqrt(F * p * (1 - p))
    P = p[:, None] + sd[:, None] * torch.randn(M, K, generator=gen,
                                               device=device)
    fmin = float(traffic["freq_clip"])
    P = P.clamp_(fmin, 1 - fmin)
    Q = _dirichlet(gen, N, K, float(traffic["dirichlet_alpha"]), device)
    return P, Q


def simulate_panel(traffic: Dict, seed: int, device, block_rows: int = 512
                   ) -> Tuple[np.ndarray, torch.Tensor]:
    """(packed (N, m_pad / 4) uint8 in host memory, P* on ``device``).

    On a card each block's packed rows go to the host through two pinned
    buffers in turn, so the copy of one block overlaps the next block's
    draws (a pageable copy into fresh host memory is three times
    slower)."""
    P, Q = truth(traffic, seed, device)
    gen = generator(device, seed, 2)
    N, M = int(traffic["samples"]), int(traffic["snps"])
    m_pad = padded_snps(traffic)
    rate = float(traffic["missing_rate"])
    out = np.empty((N, m_pad // 4), np.uint8)
    host = torch.from_numpy(out)
    Pt = P.T.contiguous()
    staged = _Staging(host, block_rows, device)
    for r0 in range(0, N, block_rows):
        r1 = min(N, r0 + block_rows)
        f = Q[r0:r1] @ Pt
        u = torch.rand(r1 - r0, M, generator=gen, device=device)
        codes = (u > (1 - f) ** 2).to(torch.uint8)
        codes += (u > 1 - f * f).to(torch.uint8)
        del f
        miss = torch.rand(r1 - r0, M, generator=gen, device=device) < rate
        codes.masked_fill_(miss, 3)
        staged.put(r0, pack_codes(codes, m_pad))
    staged.flush()
    return out, P


class _Staging:
    """Device blocks to rows of ``host``: on a card through two pinned
    buffers used in turn, elsewhere by a plain copy."""

    def __init__(self, host: torch.Tensor, rows: int, device):
        self.host = host
        self.card = torch.device(device).type == "cuda"
        self.pending = None
        if self.card:
            self.bufs = [torch.empty(rows, host.shape[1], dtype=host.dtype,
                                     pin_memory=True) for _ in range(2)]
            self.done = [torch.cuda.Event(), torch.cuda.Event()]
            self.turn = 0

    def put(self, r0: int, block: torch.Tensor) -> None:
        """Start ``block``'s copy to host rows r0.. and land the one before
        it."""
        if not self.card:
            self.host[r0:r0 + block.shape[0]].copy_(block)
            return
        i = self.turn
        self.turn ^= 1
        self.done[i].synchronize()
        self.bufs[i][:block.shape[0]].copy_(block, non_blocking=True)
        self.done[i].record()
        self.flush()
        self.pending = (i, r0, block.shape[0])

    def flush(self) -> None:
        """Land the block copied before the newest one (or, at the end, the
        newest one) in host memory."""
        if self.pending is None:
            return
        i, r0, n = self.pending
        self.done[i].synchronize()
        self.host[r0:r0 + n].copy_(self.bufs[i][:n])
        self.pending = None


def init_params(config: Dict, P_star: torch.Tensor, m_pad: int, seed: int,
                device) -> Dict:
    """The initial parameter dict (numpy fp32, the layout launch_training
    takes)."""
    gen = generator(device, seed, 3)
    M, K_star = P_star.shape
    D, H = int(config["n_components"]), int(config["hidden_size"])
    if D > K_star:
        raise ValueError(f"{D} components from {K_star} populations")
    basis = torch.linalg.qr(P_star.double())[0][:, :D].float()
    V = torch.zeros(m_pad, D, device=device)
    V[:M] = basis

    def linear(fan_in, fan_out):
        bound = 1.0 / float(np.sqrt(fan_in))
        w = (torch.rand(fan_in * fan_out + fan_out, generator=gen,
                        device=device) * 2 - 1) * bound
        return {"kernel": w[:fan_in * fan_out].reshape(fan_in, fan_out),
                "bias": w[fan_in * fan_out:]}

    params = {"V": V, "rmsnorm": {"weight": torch.ones(D, device=device)},
              "common": linear(D, H), "heads": {}, "decoders": {}}
    for k in sorted(config["ks"]):
        params["heads"][f"k{k}"] = linear(H, k)
        mix = -torch.log(torch.rand(K_star, k, generator=gen, device=device))
        mix = mix / mix.sum(0, keepdim=True)
        Pk = torch.zeros(k, m_pad, device=device)
        Pk[:, :M] = (P_star @ mix).T.clamp(P_CLIP, 1 - P_CLIP)
        params["decoders"][f"k{k}"] = Pk
    return to_numpy(params)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).contiguous().numpy()
