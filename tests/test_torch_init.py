"""``models.init_weights`` against flax's own initializers, on the CPU.

The JAX package draws every conv and transposed conv kernel with
``he_normal`` (models/blocks.py:24 ``conv_init``), the Dense kernels of the
MLPs and the general attentions with ``xavier_normal`` (blocks.py:163,
attention.py:73, 93-94, 123) and AdditiveAttention's three Dense kernels with
flax's default ``lecun_normal`` (attention.py:56-58). Each is
``variance_scaling(scale, mode, "truncated_normal")``: a normal cut at +-2,
divided by its std 0.8796..., so ``|w| <= 2 sqrt(var) / 0.8796`` and the std
is ``sqrt(var)``. For the flagship (``mrms_when2com.yml``) and for
LearnWho2Com with ``attention: additive`` and ``feat_squeezer: 2`` (its
transposed convs; ``feat_channel`` 128 and one encoder to keep it small),
every weight of the port's seeded draw:

- lies within flax's bound, which the largest layers nearly reach;
- has the std ``sqrt(var)`` within 2% (each layer of at least 2^15 weights,
  and each kind's weights pooled, each divided by its layer's sqrt(var));
- is drawn as flax draws: the two-sample Kolmogorov-Smirnov statistic
  between the port's largest layer of a kind and flax's initializer at
  its shape, 2^17 weights of each (all, where the layer holds fewer),
  stays under the critical value at alpha = 1e-3 for 2^17 a side,
  1.95 sqrt(2 / 2^17) = 0.0076; untruncated normals of the same variance
  (the port's draw before the truncation) exceed it, so the test tells the
  two apart.

And, on one layer of each kind, the same seed gives the same weights twice,
another seed others, and a layer sharded over a model group of 2
(``parallel.tensor``) keeps the slice of the whole draw.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import linen as nn
from scipy.stats import ks_2samp

from multiagentperception_tpu_torch.models import (
    TRUNC_STD,
    _truncated_normal,
    get_model,
    init_weights,
)
from multiagentperception_tpu_torch.models.attention import AdditiveAttention
from multiagentperception_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, Linear
from multiagentperception_tpu_torch.parallel import tensor
from multiagentperception_tpu_torch.parallel.collectives import Group

SEED = 5
SAMPLES = 2 ** 17
KS_BOUND = 1.95 * math.sqrt(2.0 / SAMPLES)  # alpha = 1e-3, n = m = SAMPLES
STD_TOL = 0.02
LARGE = 2 ** 15  # a layer's own std is held from this many weights up
# flax's initializer of each kind (models/blocks.py:24, :163; attention.py:56-58, :73)
FLAX_INIT = {"he": nn.initializers.he_normal(), "xavier": nn.initializers.xavier_normal(),
             "lecun": nn.initializers.lecun_normal()}
ROOT = Path(__file__).resolve().parents[1]
ADDITIVE = ("attention_net.linear_feat", "attention_net.linear_context",
            "attention_net.linear_out")


def _cfg(path: str, **model) -> dict:
    with open(ROOT / "configs" / path) as fp:
        cfg = yaml.safe_load(fp)
    cfg["data"]["img_rows"] = cfg["data"]["img_cols"] = 64
    cfg["model"].update(model)
    return cfg


CONFIGS = {
    "flagship": lambda: _cfg("multi-request-multi-support/mrms_when2com.yml"),
    "additive": lambda: _cfg("single-request-multiple-support/srms_who2com.yml",
                             attention="additive", feat_squeezer=2, feat_channel=128,
                             shared_img_encoder="unified"),
}


def _layers(model: torch.nn.Module) -> list:
    """(name, kind, flax kernel shape, var, weights, module) of every drawn
    layer, by the JAX package's rule for the flax layer it stands for."""
    out = []
    for name, mod in model.named_modules():
        w = getattr(mod, "weight", None)
        if isinstance(mod, torch.nn.ConvTranspose2d):  # (in, out, kh, kw)
            i, o, kh, kw = w.shape
            kind, shape, var = "he", (kh, kw, i, o), 2.0 / (kh * kw * i)
        elif isinstance(mod, torch.nn.Conv2d):  # (out, in, kh, kw)
            o, i, kh, kw = w.shape
            kind, shape, var = "he", (kh, kw, i, o), 2.0 / (kh * kw * i)
        elif isinstance(mod, torch.nn.Linear):  # (out, in)
            o, i = w.shape
            if name in ADDITIVE:
                kind, var = "lecun", 1.0 / i
            else:
                kind, var = "xavier", 2.0 / (i + o)
            shape = (i, o)
        else:
            continue
        out.append((name, kind, shape, var, w.detach().numpy().ravel().copy(), mod))
    return out


def _sample(w: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return w if w.size <= SAMPLES else w[rng.integers(0, w.size, SAMPLES)]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test runner's parallel workers would otherwise
    each start one per core and crowd the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def drawn(request):
    cfg = CONFIGS[request.param]()
    return request.param, _layers(init_weights(get_model(cfg, 11), SEED))


def _small() -> torch.nn.Module:
    """One layer of each kind, the model axis's threshold (64 outputs) met."""
    return torch.nn.Sequential(Conv2d(16, 64, 3), Linear(32, 128), ConvTranspose2d(64, 64, 2),
                               torch.nn.BatchNorm2d(64), AdditiveAttention(8, 64))


def test_kinds_are_the_jax_packages(drawn):
    """The flagship holds he convs and xavier linears; the additive model
    lecun linears and he transposed convs too."""
    name, layers = drawn
    kinds = {kind for _, kind, *_ in layers}
    assert kinds == ({"he", "xavier"} if name == "flagship" else {"he", "xavier", "lecun"})
    lecun = {n for n, kind, *_ in layers if kind == "lecun"}
    assert lecun == (set() if name == "flagship" else set(ADDITIVE))
    transposed = [n for n, *_, mod in layers if isinstance(mod, torch.nn.ConvTranspose2d)]
    assert bool(transposed) == (name == "additive")


def test_weights_within_flax_truncation(drawn):
    for name, _, _, var, w, _ in drawn[1]:
        bound = 2.0 * math.sqrt(var) / TRUNC_STD
        top = np.abs(w).max()
        assert top <= bound * (1 + 1e-6), (name, top, bound)
        if w.size >= LARGE:  # the cut is where flax's is, not inside it
            assert top >= 0.97 * bound, (name, top, bound)


def test_std_is_sqrt_var(drawn):
    pooled: dict[str, list] = {}
    for name, kind, _, var, w, _ in drawn[1]:
        pooled.setdefault(kind, []).append(w / math.sqrt(var))
        if w.size >= LARGE:
            assert abs(w.std() / math.sqrt(var) - 1) < STD_TOL, (name, w.std(), math.sqrt(var))
    for kind, values in pooled.items():
        std = np.concatenate(values).std()
        assert abs(std - 1) < STD_TOL, (kind, std)


@pytest.mark.parametrize("kind", sorted(FLAX_INIT))
def test_ks_against_flax(drawn, kind):
    """The kind's largest layer against flax's initializer at its shape;
    untruncated normals of its variance are told apart."""
    name, layers = drawn
    of_kind = [layer for layer in layers if layer[1] == kind]
    if not of_kind:
        assert name == "flagship" and kind == "lecun"  # no AdditiveAttention there
        return
    _, _, shape, var, w, _ = max(of_kind, key=lambda layer: layer[4].size)
    flax = np.asarray(FLAX_INIT[kind](jax.random.PRNGKey(SEED), shape, np.float32)).ravel()
    rng = np.random.default_rng(SEED)
    flax = _sample(flax, rng)
    stat = ks_2samp(_sample(w, rng), flax).statistic
    assert stat < KS_BOUND, (kind, shape, stat, KS_BOUND)
    plain = torch.randn(w.size, generator=torch.Generator().manual_seed(SEED)) * math.sqrt(var)
    assert ks_2samp(_sample(plain.numpy(), rng), flax).statistic > KS_BOUND, (kind, shape)


def test_same_seed_same_weights():
    first, again, other = (init_weights(_small(), seed).state_dict()
                           for seed in (SEED, SEED, SEED + 1))
    assert all(torch.equal(first[k], again[k]) for k in first)
    drawn_keys = [k for k in first if k.endswith("weight") and first[k].dim() > 1]
    assert len(drawn_keys) == 6
    assert not any(torch.equal(first[k], other[k]) for k in drawn_keys)


def test_shard_is_the_whole_draws_slice():
    """Rank 1 of a model group of 2 (no process group: ``parallelize`` reads
    the group's size and rank alone)."""
    whole = init_weights(_small(), SEED).state_dict()
    model = _small()
    # the conv, the linear, the transposed conv and two of the additive linears
    assert tensor.parallelize(model, Group((0, 1), 1, "gloo", torch.device("cpu"))) == 5
    init_weights(model, SEED)
    for name, mod in model.named_modules():
        if isinstance(mod, tensor.ColumnParallel):
            assert mod.offset > 0
            assert torch.equal(mod.weight, mod.take(whole[name + ".weight"])), name


def test_draw_is_the_inverse_cdf():
    """The draw is a uniform between -erf(sqrt 2) and erf(sqrt 2) through
    ``erfinv`` (``jax.random.truncated_normal``'s method, and torch 2.11's
    ``trunc_normal_``): the same weights under every torch version that
    draws the same uniforms."""
    std = 0.05
    gen = torch.Generator().manual_seed(SEED)
    want = torch.empty(4096).uniform_(-math.erf(math.sqrt(2.0)), math.erf(math.sqrt(2.0)),
                                      generator=gen).erfinv_() * (std * math.sqrt(2.0))
    got = _truncated_normal((4096,), std, torch.Generator().manual_seed(SEED))
    torch.testing.assert_close(got, want.clamp(-2 * std, 2 * std), rtol=0, atol=0)
