"""Direct label-inference attack (paper §VI-B, Table I, after Fu et al.)
and the feature-inference attack (§V-B, after Luo et al.).

Ported from the JAX package's ``core/attacks.py``. Threat model: the
server is a "model without split" — it *sums* the client outputs (one
logit per class) and answers queries. A curious client crafts a query to
recover ∂L/∂y^c; the true label is the class with negative sign.

* FOO frameworks (Split-Learning / VAFL) transmit that partial derivative
  verbatim → the attack succeeds with certainty.
* ZOO frameworks reply only with two scalar losses (h, ĥ); the curious
  client's best move is the one-query gradient *estimate*
  φ(d)/μ (ĥ−h) u — a rank-one guess whose argmin is barely better than
  chance. An eavesdropper never sees u at all (the client keeps it) and
  must guess its own u' → chance level.

The JAX package draws with threefry keys; here every random number comes
from a draw source (:class:`AttackDraws`), as in ``core/draws.py``:
:class:`TorchAttackDraws` serves a standalone run from a seeded
``torch.Generator`` on the run's device, and the parity tests hand in the
JAX package's own draws. The feature attack's least-squares inversion is
the minimum-norm solution through the pseudo-inverse with the JAX
package's cutoff (singular values below ``eps · max(M, N)`` times the
largest are dropped), on the CPU and on the card alike: ``Wa`` has zero
columns for the inactive units, so the system is rank-deficient, and
CUDA's ``torch.linalg.lstsq`` has only the full-rank ``gels`` driver.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class AttackResult:
    curious_client_acc: float
    eavesdropper_acc: float


@dataclasses.dataclass(frozen=True)
class FeatureAttackResult:
    mse_with_model_access: float    # Luo et al.-style inversion (needs F_m)
    mse_black_box: float            # our framework: F_m is a black box
    mse_chance: float               # guess-the-mean floor


class AttackDraws(Protocol):
    def label_draws(self, n_samples: int, n_classes: int
                    ) -> Tuple[torch.Tensor, ...]:
        """(labels (n,) int64 in [0, n_classes), the crafted query c, the
        client's secret u and the eavesdropper's guess u' — each (n,
        n_classes) f32 N(0, 1))."""

    def feature_draws(self, n: int, f: int, e: int
                      ) -> Tuple[torch.Tensor, ...]:
        """(x (n, f), W (f, e), b (e,)), each f32 N(0, 1); the attack
        scales W by 1/√f and b by 0.1."""


class TorchAttackDraws:
    """The attacks' draws from one seeded ``torch.Generator`` on
    ``device``."""

    def __init__(self, seed: int, device) -> None:
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def _normal(self, *shape):
        return torch.randn(shape, generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def label_draws(self, n_samples, n_classes):
        labels = torch.randint(0, n_classes, (n_samples,),
                               generator=self.generator, device=self.device)
        return (labels, self._normal(n_samples, n_classes),
                self._normal(n_samples, n_classes),
                self._normal(n_samples, n_classes))

    def feature_draws(self, n, f, e):
        return self._normal(n, f), self._normal(f, e), self._normal(e)


def _sum_server_loss(c_sum, labels):
    """The vulnerable server: logits = Σ_m c_m; per-sample CE loss."""
    lse = torch.logsumexp(c_sum, dim=-1)
    gold = torch.gather(c_sum, -1, labels[:, None])[:, 0]
    return lse - gold                                     # (B,)


def grad_wrt_output(c_sum, labels):
    """∂L/∂y — what a FOO server sends back (softmax − one-hot)."""
    p = torch.softmax(c_sum, dim=-1)
    onehot = (labels[:, None] == torch.arange(c_sum.shape[-1],
                                              device=c_sum.device))
    return p - onehot.to(p.dtype)


def _draws_for(draws, seed: int, device: DeviceLike):
    if draws is not None:
        return draws
    return TorchAttackDraws(seed, resolve_device(device))


def run_label_inference(n_classes: int, n_samples: int, mu: float = 1e-3,
                        framework: str = "zoo", *, seed: int = 0,
                        draws: Optional[AttackDraws] = None,
                        device: DeviceLike = None) -> AttackResult:
    """Simulate the attack over ``n_samples`` queries. Returns accuracies.

    framework: "foo" (gradient on the wire) or "zoo" (losses only). The
    draws come from ``draws``, else from a generator seeded with ``seed``
    on ``device`` (the card unless ``device="cpu"``); the run happens on
    the draws' device."""
    labels, c, u, u_eaves = _draws_for(draws, seed, device).label_draws(
        n_samples, n_classes)
    labels = labels.long()

    if framework == "foo":
        # the wire carries ∂L/∂y itself — both attacker roles read it
        g = grad_wrt_output(c, labels)
        pred_client = torch.argmin(g, dim=-1)             # negative entry
        pred_eaves = pred_client
    else:
        h = _sum_server_loss(c, labels)
        h_hat = _sum_server_loss(c + mu * u, labels)
        coef = (h_hat - h)[:, None] / mu                  # scalar per query
        pred_client = torch.argmin(coef * u, dim=-1)      # client knows u
        # eavesdropper saw (c, ĉ, h, ĥ) but NOT u — guesses its own
        pred_eaves = torch.argmin(coef * u_eaves, dim=-1)

    acc_c = float(torch.mean((pred_client == labels).float()))
    acc_e = float(torch.mean((pred_eaves == labels).float()))
    return AttackResult(curious_client_acc=acc_c, eavesdropper_acc=acc_e)


def run_feature_inference(n: int = 512, f: int = 16, e: int = 32, *,
                          seed: int = 1,
                          draws: Optional[AttackDraws] = None,
                          device: DeviceLike = None) -> FeatureAttackResult:
    """Feature-inference attack (paper §V-B, after Luo et al. [27]).

    The server observes the client's embeddings c = relu(xW + b) and tries
    to reconstruct the private features x.

    * With MODEL ACCESS (the assumption of [27] — client model known, e.g.
      a colluding party leaked it): invert the relu-affine map by solving
      the least-squares system on the active units — reconstruction
      succeeds (low MSE).
    * BLACK BOX (our framework's protocol: F_m never leaves the client):
      the embeddings carry no usable inverse — the best generic attacker
      guess is the population mean (MSE ≈ feature variance).
    """
    x, w_raw, b_raw = _draws_for(draws, seed, device).feature_draws(n, f, e)
    W = w_raw / math.sqrt(f)
    b = b_raw * 0.1
    pre = x @ W + b
    c = torch.relu(pre)

    # --- with model access: recover pre-activations on active units and
    # solve x̂ = argmin ||x W - (c - b)|| restricted to active columns, the
    # minimum-norm solution where the active columns leave x free
    active = c > 0
    target = torch.where(active, c - b, 0.0)
    Wa_t = (W[None] * active[:, None, :].float()).transpose(1, 2)  # (n,e,f)
    rcond = torch.finfo(torch.float32).eps * max(e, f)
    x_hat = (torch.linalg.pinv(Wa_t, rtol=rcond) @ target[..., None])[..., 0]
    mse_model = float(torch.mean(torch.square(x_hat - x)))

    # --- black box: F_m unknown -> attacker predicts the mean
    mse_bb = float(torch.mean(torch.square(torch.mean(x, 0) - x)))
    mse_chance = float(torch.var(x, correction=0))
    return FeatureAttackResult(mse_with_model_access=mse_model,
                               mse_black_box=mse_bb,
                               mse_chance=mse_chance)
