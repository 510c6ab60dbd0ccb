"""FlyMC over an LM head: the paper's technique on the LM backbones.

The port's counterpart of :mod:`repro.models.lastlayer`. Full-parameter
FlyMC does not apply to a deep net (it has no collapsible bound), but its
readout is the paper's softmax experiment: given frozen backbone features
h ∈ R^{T×d} and next-token labels, the per-token likelihood is softmax(θh)
with θ the (V, d) head, and the Böhning bound collapses through S = Σ h hᵀ
and R = Σ h rᵀ. This module takes the (features, labels) GLM view of any
backbone the port runs and returns a ready-to-sample
:class:`~repro_torch.models.bayes_glm.GLMModel`: exact Bayesian inference
over the head, paying likelihood evaluations only for the bright tokens.
On the card those run through ``bright_glm``'s wide softmax kernel (an LM
vocabulary has far more than its register kernel's 16 classes).
"""

from __future__ import annotations

import torch

from repro_torch.core.bounds import GLMData
from repro_torch.models import transformer as T
from repro_torch.models.bayes_glm import GLMModel


@torch.no_grad()
def extract_features(model: T.LM, tokens, dtype=torch.float32):
    """Frozen-backbone features (B·(S−1), d) of ``tokens`` (B, S), from
    :func:`~repro_torch.models.transformer.forward_hidden` in ``dtype``
    (float32, as the reference's), and the shifted labels (B·(S−1),)."""
    h = T.forward_hidden(model, tokens, dtype)
    feats = h[:, :-1].reshape(-1, model.cfg.d_model)
    labels = tokens[:, 1:].reshape(-1)
    return feats, labels


def lastlayer_glm(model: T.LM, tokens, prior_scale: float = 1.0) -> GLMModel:
    """GLMModel whose posterior is the Bayesian LM-head posterior: the
    softmax family over ``cfg.padded_vocab()`` classes with tangency logits
    ξ = 0 until :meth:`~repro_torch.models.bayes_glm.GLMModel.map_tuned`.
    It lives on the features' device."""
    feats, labels = extract_features(model, tokens)
    n_classes = model.cfg.padded_vocab()
    data = GLMData(x=feats.float(), t=labels.to(torch.int64),
                   xi=torch.zeros(feats.shape[0], n_classes,
                                  device=feats.device))
    return GLMModel.softmax(data, n_classes=n_classes,
                            prior_scale=prior_scale, device=feats.device)
