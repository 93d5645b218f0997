"""PyTorch port vs the JAX package: the serving path of the six families
after the dense one (``models.serve`` with ``moe``, MLA, ``mamba2``,
the hybrid, encoder-decoder and VLM families), each smoke configuration
with the reference's weights:

* ``prefill`` logits and every cache leaf against
  ``repro.models.serve.prefill``, LLaVA included (the reference's own
  test skips it against the forward);
* every ``decode_step``'s logits and leaves against the reference's
  jitted step, and one step from a reference cache taken mid-sequence;
* ``prefill_encoder`` for encdec (the encoder, cross k / v per layer).

The MoE configurations run at their configured capacity factor (1.25:
a decode step of 2 tokens gives each expert 1 slot, so tokens are
dropped) and at the reference test's 8.0. Tolerances as in
``test_torch_serve.py`` (float32: 1e-5 of the scale).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_parity import one_torch_thread  # noqa: F401 (fixture)
from test_torch_serve import (check_serving, port_cache, port_model,
                              reference_serving, same_cache)
from repro_torch.models import serve as TS

CASES = [
    ("mixtral-8x22b", {}),                           # S = 24 > window 16
    ("mixtral-8x22b", {"capacity_factor": 8.0}),
    ("deepseek-v3-671b", {}),
    ("mamba2-780m", {}),
    ("zamba2-7b", {}),
    ("seamless-m4t-medium", {}),
    ("llava-next-mistral-7b", {}),
]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}{'-cf8' if o else ''}" for a, o in CASES])
def family_ref(request):
    arch, over = request.param
    return arch, reference_serving(arch, **over)


def test_family_serving_matches_reference(family_ref):
    check_serving(*family_ref)


def test_prefill_encoder_matches_reference():
    arch = "seamless-m4t-medium"
    ref = reference_serving(arch, mid=3)
    cfg, model = port_model(arch, ref)
    with torch.inference_mode():
        cache = port_cache(cfg, model, ref)
    assert cache["cross_k"].shape == (cfg.n_layers, 2, cfg.n_heads, 16,
                                      cfg.dh)
    same_cache(cache, ref["first"])


def test_mamba_cache_layers_are_their_own():
    """The reference broadcasts one layer's zero cache over the layers
    (a real array in JAX); the port materialises each layer's, so a step
    that writes layer 0's state leaves layer 1's alone."""
    from repro_torch import get_config
    for arch in ("mamba2-780m", "zamba2-7b"):
        cfg = get_config(arch, smoke=True)
        cache = TS.init_cache(cfg, 2, 8, device="cpu")
        assert cache["state"].dtype == cache["conv"].dtype == torch.float32
        cache["state"][0].add_(1.0)
        cache["conv"][0].add_(1.0)
        assert float(cache["state"][1].abs().max()) == 0.0
        assert float(cache["conv"][1].abs().max()) == 0.0


def test_mla_cache_splits_dense_and_moe_layers():
    """DeepSeek's first_k_dense layers take the first rows of the stacked
    latent cache: after one step from zero, each layer wrote its own row
    0, no other row."""
    from repro_torch import LM, get_config
    cfg = get_config("deepseek-v3-671b", smoke=True)
    model = LM.from_config(cfg, seed=0, device="cpu")
    cache = TS.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    with torch.inference_mode():
        TS.decode_step(model, cache, torch.zeros((2, 1), dtype=torch.long))
    rows = cache["ckv"].abs().sum((1, 3))                     # (L, S)
    assert bool((rows[:, 0] > 0).all()) and float(rows[:, 1:].max()) == 0
    assert len(model.dense_layers) == cfg.first_k_dense
    assert len(model.layers) == cfg.n_layers - cfg.first_k_dense
    assert dataclasses.asdict(model.dense_layers[0].cfg)["n_experts"] == 0
    assert np.isfinite(cache["kr"].numpy()).all()
