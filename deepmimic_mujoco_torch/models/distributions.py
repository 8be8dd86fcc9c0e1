"""Action distributions (port of ``deepmimic_mujoco_tpu/models/
distributions.py``): the diagonal Gaussian of ``MlpPolicy``, the
categorical, Bernoulli and multi-categorical families over logits, with the
reference's logp, KL and entropy formulas, ``make_pdtype`` and the
statistical self-test ``validate_probtype``.  Stateless: parameters are
passed explicitly, and sampling takes a ``torch.Generator``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG2PI = math.log(2.0 * math.pi)
_LOG2PIE = math.log(2.0 * math.pi * math.e)


class diag_gaussian:
    @staticmethod
    def neglogp(mean: torch.Tensor, logstd: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        std = torch.exp(logstd)
        return (0.5 * torch.sum(torch.square((x - mean) / std), dim=-1)
                + 0.5 * _LOG2PI * x.shape[-1]
                + torch.sum(logstd, dim=-1))

    @staticmethod
    def logp(mean: torch.Tensor, logstd: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
        return -diag_gaussian.neglogp(mean, logstd, x)

    @staticmethod
    def kl(mean_p: torch.Tensor, logstd_p: torch.Tensor,
           mean_q: torch.Tensor, logstd_q: torch.Tensor) -> torch.Tensor:
        """KL(p ‖ q)."""
        std_p, std_q = torch.exp(logstd_p), torch.exp(logstd_q)
        return torch.sum(
            logstd_q - logstd_p
            + (torch.square(std_p) + torch.square(mean_p - mean_q))
            / (2.0 * torch.square(std_q)) - 0.5, dim=-1)

    @staticmethod
    def entropy(logstd: torch.Tensor) -> torch.Tensor:
        return torch.sum(logstd + 0.5 * _LOG2PIE, dim=-1)

    @staticmethod
    def sample(generator: torch.Generator, mean: torch.Tensor,
               logstd: torch.Tensor) -> torch.Tensor:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(logstd) * noise

    @staticmethod
    def mode(mean: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
        return mean


def _softmax_parts(logits: torch.Tensor):
    """(a, z, p): logits shifted by their max, the partition sum, the
    probabilities."""
    a = logits - torch.amax(logits, dim=-1, keepdim=True)
    ea = torch.exp(a)
    z = torch.sum(ea, dim=-1, keepdim=True)
    return a, z, ea / z


class categorical:
    """Categorical over logits (the last axis)."""

    @staticmethod
    def neglogp(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, x.long()[..., None])[..., 0]

    @staticmethod
    def kl(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
        a0, z0, p0 = _softmax_parts(logits_p)
        a1, z1, _ = _softmax_parts(logits_q)
        return torch.sum(p0 * (a0 - torch.log(z0) - a1 + torch.log(z1)),
                         dim=-1)

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        a0, z0, p0 = _softmax_parts(logits)
        return torch.sum(p0 * (torch.log(z0) - a0), dim=-1)

    @staticmethod
    def sample(generator: torch.Generator, logits: torch.Tensor
               ) -> torch.Tensor:
        """Gumbel-max: argmax(logits − log(−log u)), u ~ U(0, 1)."""
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=logits.dtype)
        u = torch.clamp(u, min=torch.finfo(logits.dtype).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    @staticmethod
    def mode(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)


class bernoulli:
    """Independent Bernoulli variables over logits (the last axis)."""

    @staticmethod
    def neglogp(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = x.to(logits.dtype)
        return torch.sum(torch.clamp(logits, min=0) - logits * x
                         + torch.log1p(torch.exp(-torch.abs(logits))),
                         dim=-1)

    @staticmethod
    def kl(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
        ps = torch.sigmoid(logits_p)
        return torch.sum(
            ps * (F.logsigmoid(logits_p) - F.logsigmoid(logits_q))
            + (1 - ps) * (F.logsigmoid(-logits_p) - F.logsigmoid(-logits_q)),
            dim=-1)

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        ps = torch.sigmoid(logits)
        return torch.sum(-ps * F.logsigmoid(logits)
                         - (1 - ps) * F.logsigmoid(-logits), dim=-1)

    @staticmethod
    def sample(generator: torch.Generator, logits: torch.Tensor
               ) -> torch.Tensor:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=logits.dtype)
        return (u < torch.sigmoid(logits)).to(torch.int32)


class multi_categorical:
    """Independent categoricals, parameterized by flat logits split into
    ``sizes`` per sub-action."""

    @staticmethod
    def _split(logits: torch.Tensor, sizes) -> list[torch.Tensor]:
        return list(torch.split(logits, list(sizes), dim=-1))

    @staticmethod
    def neglogp(logits: torch.Tensor, sizes, x: torch.Tensor
                ) -> torch.Tensor:
        parts = multi_categorical._split(logits, sizes)
        return sum(categorical.neglogp(part, x[..., i])
                   for i, part in enumerate(parts))

    @staticmethod
    def kl(logits_p: torch.Tensor, logits_q: torch.Tensor, sizes
           ) -> torch.Tensor:
        pp = multi_categorical._split(logits_p, sizes)
        qq = multi_categorical._split(logits_q, sizes)
        return sum(categorical.kl(a, b) for a, b in zip(pp, qq))

    @staticmethod
    def entropy(logits: torch.Tensor, sizes) -> torch.Tensor:
        return sum(categorical.entropy(part)
                   for part in multi_categorical._split(logits, sizes))

    @staticmethod
    def sample(generator: torch.Generator, logits: torch.Tensor, sizes
               ) -> torch.Tensor:
        parts = multi_categorical._split(logits, sizes)
        return torch.stack([categorical.sample(generator, part)
                            for part in parts], dim=-1)


def make_pdtype(space):
    """A gym/gymnasium space (dispatched on its class name, so no gym
    import) → (family, param_size, sample_dtype_kind)."""
    name = type(space).__name__
    if name == "Box":
        if len(space.shape) != 1:
            raise NotImplementedError(f"Box of shape {space.shape}")
        return diag_gaussian, 2 * space.shape[0], "float"
    if name == "Discrete":
        return categorical, int(space.n), "int"
    if name == "MultiDiscrete":
        sizes = [int(n) for n in space.nvec]
        return multi_categorical, sum(sizes), "int"
    if name == "MultiBinary":
        return bernoulli, int(space.n), "int"
    raise NotImplementedError(f"no distribution for space {space!r}")


def validate_probtype(sample_a, neglogp_a, neglogp_b, entropy_a, kl_ab,
                      generator: torch.Generator, n: int = 100_000):
    """Statistical self-test: over ``n`` samples of distribution *a*
    (``sample_a(generator, n) → x`` with a leading sample axis) the mean
    NLL must match the analytic entropy, and the mean of
    ``neglogp_b − neglogp_a`` must match KL(a‖b), each within 3 standard
    errors.  Raises AssertionError on failure; returns the two z-scores."""
    xs = sample_a(generator, n)
    nll_a = neglogp_a(xs).double()
    ent_hat, ent_sem = nll_a.mean(), nll_a.std(correction=0) / math.sqrt(n)
    z_ent = float(abs(ent_hat - float(entropy_a)) / max(float(ent_sem),
                                                         1e-12))
    if not z_ent < 3.0:
        raise AssertionError(f"entropy mismatch: {float(ent_hat)} vs "
                             f"{float(entropy_a)} (z={z_ent:.2f})")
    diff = neglogp_b(xs).double() - nll_a
    kl_hat, kl_sem = diff.mean(), diff.std(correction=0) / math.sqrt(n)
    z_kl = float(abs(kl_hat - float(kl_ab)) / max(float(kl_sem), 1e-12))
    if not z_kl < 3.0:
        raise AssertionError(f"KL mismatch: {float(kl_hat)} vs "
                             f"{float(kl_ab)} (z={z_kl:.2f})")
    return z_ent, z_kl
