"""Every configuration of ``repro_torch.configs`` in the port: each of the
ten initialises, runs forward, trains a step and decodes on the CPU at a
reduced size, and its train state has the JAX package's layout (leaf
paths, shapes, dtypes) — reduced on the CPU and full-size on the ``meta``
device, against ``jax.eval_shape(init_train_state)``, so nothing
full-size is allocated.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.serialization import path_str as jax_path_str
from repro.train.steps import init_train_state as jax_init_state
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.serialization import (dtype_name, path_str,
                                            tree_leaves_with_path)
from repro_torch.models import transformer as T
from repro_torch.train.steps import init_train_state, make_train_step


def _reduced(get, arch):
    """The reference's reduced size (``tests/test_models.py``)."""
    return get(arch).scaled_down(
        layers=13 if arch == "recurrentgemma-2b" else 2, width_div=16,
        vocab=128)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_runs_on_the_cpu(arch):
    """Forward (the frontend prefix included), one train step that moves
    the params, and one decode step: shapes and finite values."""
    cfg = _reduced(get_config, arch)
    B, S = 2, 16
    state = init_train_state(cfg, seed=0, device="cpu")
    fe = (torch.ones((B, cfg.frontend_len, cfg.frontend_dim))
          if cfg.frontend else None)
    tokens = torch.ones((B, S), dtype=torch.int32)
    with torch.no_grad():
        logits, aux = T.forward(state["params"], cfg, tokens, fe)
    assert logits.shape == (B, S + (cfg.frontend_len if fe is not None
                                    else 0), cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and (float(aux) > 0) == \
        cfg.is_moe
    batch = {"tokens": tokens, "labels": tokens}
    if fe is not None:
        batch["frontend_embeds"] = fe
    w0 = tree_leaves_with_path(state["params"])[0][1].clone()
    state, m = make_train_step(cfg)(state, batch)
    assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1
    assert not torch.equal(tree_leaves_with_path(state["params"])[0][1], w0)
    cache = T.init_cache(cfg, B, 8, device="cpu")
    out, cache = T.decode_step(state["params"], cfg, cache, tokens[:, :1],
                               torch.zeros((B, 1), dtype=torch.int32))
    assert out.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(out).all())


def _layout_of_port(state) -> list:
    return [(path_str(p), tuple(t.shape), dtype_name(t.dtype))
            for p, t in tree_leaves_with_path(state)]


def _layout_of_jax(jcfg) -> list:
    shapes = jax.eval_shape(lambda: jax_init_state(jax.random.key(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(jax_path_str(p), tuple(s.shape), str(s.dtype)) for p, s in flat]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_train_state_layout(arch):
    assert _layout_of_port(init_train_state(
        _reduced(get_config, arch), device="cpu")) == \
        _layout_of_jax(_reduced(jax_config, arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_train_state_layout_on_meta(arch):
    state = init_train_state(get_config(arch), device="meta")
    assert {t.device.type for _, t in tree_leaves_with_path(state)} == \
        {"meta"}
    assert _layout_of_port(state) == _layout_of_jax(jax_config(arch))
