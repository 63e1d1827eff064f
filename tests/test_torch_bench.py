"""The port's bench (``python -m multiagentperception_tpu_torch.bench``) on
the CPU: its JSON contract at the ``--tiny`` shape, its FLOP count against
the JAX package's (XLA's ``cost_analysis``), and its eval step against the
JAX bench's step on the same weights and inputs.

The FLOP count, and why the tolerances:

- Per convolution, the padding-free count equals XLA's exactly, forward
  and backward (7x7/2, 3x3/1, 3x3/2, 1x1/2 and a 3x3 on a 2x2 map, where 5
  of every 9 taps fall on padding).
- Per step, XLA also counts work that ``FlopCounterMode`` does not: the
  JAX confusion matrix is a one-hot matmul (2 * pixels * 11 * 11 FLOPs;
  the port's ``bincount`` does no multiply-add), Adam's update in the
  train step (not counted by the bench), and about one FLOP per element of
  every elementwise operation (BatchNorm, ReLU, the residual adds, the
  softmax, the loss). The first two are XLA's own counts of those
  functions alone, subtracted. What is left lies above the padding-free
  count by 0.57-0.68% for the eval step and 1.7-2.2% for the train step
  (which counts the backward's elementwise work too; measured at 64x64 with
  2 agents and 128x128 with 3): held to [0, 1%] and [0, 3%].
- The dense count less the padding-free count is exactly the FLOPs of the
  taps that fall on padding, counted here another way: by forward hooks on
  every convolution of a real CPU forward, each tap counted by convolving
  a mask of ones (once per forward, and once per gradient the backward
  computes: two, or one where the convolution's input needs none).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from multiagentperception_tpu.compat import import_torch_state_dict
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import cross_entropy2d as jax_cross_entropy2d
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.ops.comm import confusion_matrix as jax_confusion_matrix
from multiagentperception_tpu.utils import init_variables
from multiagentperception_tpu_torch import bench
from multiagentperception_tpu_torch.models import get_model
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((64, 2), (128, 3))  # (image side, agents), batch 1
EVAL_ELEMENTWISE = 0.01  # XLA's count above the padding-free one, at most
TRAIN_ELEMENTWISE = 0.03
CONTRACT = {"metric": str, "value": float, "unit": str, "dtype": str, "device_kind": str,
            "flops_convention": str, "eval_step_ms": float, "eval_batch": int,
            "eval_tflops_per_step": float, "eval_tflops_per_step_padfree": float,
            "eval_tflops_per_sec": float, "eval_steps": int, "eval_dispatch_ms": float,
            "train_frames_per_sec": float, "train_step_ms": float, "train_batch": int,
            "train_tflops_per_step": float, "train_tflops_per_step_padfree": float,
            "train_tflops_per_sec": float, "eval_int8_frames_per_sec": float,
            "eval_int8_step_ms": float, "eval_int8_speedup": float, "eval_int8_steps": int,
            "eval_int8_convs_per_step": int}


def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


def _jax_cfg(img: int, agents: int) -> dict:
    """bench.py:80-85's configuration in float32."""
    return jax_normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": agents, "query_size": 32,
                  "key_size": 1024, "multiple_output": True},
        "data": {"img_rows": img, "img_cols": img}})


def _jax_model(img: int, agents: int, train: bool):
    model = jax_get_model(_jax_cfg(img, agents), 11)
    kwargs = dict(train=True) if train else dict(train=False, inference="activated")
    variables = init_variables(model, {"params": jax.random.PRNGKey(0)},
                               jnp.zeros((1, agents, img, img, 3)), mo_flag=True, **kwargs)
    return model, variables


# ------------------------------------------------------------------ (a) the JSON line

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiny_bench_on_the_cpu_prints_the_contract(dtype):
    out = subprocess.run(
        [sys.executable, "-m", "multiagentperception_tpu_torch.bench", "--tiny",
         "--device", "cpu", "--dtype", dtype],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    record = json.loads(out.stdout.strip().splitlines()[-1])
    for key, kind in CONTRACT.items():
        assert isinstance(record[key], kind), (key, record.get(key))
    assert record["device_kind"] == "cpu" and record["dtype"] == dtype
    assert record["flops_convention"] == "dense"
    assert record["eval_batch"] == record["train_batch"] == 1
    assert record["eval_steps"] == 4 * (1 + 3)  # warm-up and three timed runs of K = 1, 3
    assert not set(bench.DEVICE_ONLY_KEYS) & set(record), record
    assert all(record[k] > 0 for k in CONTRACT if CONTRACT[k] is float)
    assert record["eval_tflops_per_step"] > record["eval_tflops_per_step_padfree"]
    # the int8 eval step: the towers' 2 x 20 convs, both squeezers, PolicyNet4's
    # five and the decoder's 512->256; the 11-class head stays float
    assert record["eval_int8_steps"] == record["eval_steps"]
    assert record["eval_int8_convs_per_step"] == 48


def test_bench_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--tiny"])


# ------------------------------------------------------------------ (b) FLOPs

@pytest.mark.parametrize("k,stride,pad,size,cin,cout", [
    (7, 2, 3, 32, 3, 64), (3, 1, 1, 16, 64, 64), (3, 2, 1, 16, 64, 128),
    (1, 2, 0, 16, 64, 128), (3, 1, 1, 2, 16, 32), (3, 2, 1, 5, 8, 8)],
    ids=["7x7s2", "3x3s1", "3x3s2", "1x1s2", "3x3s1_on_2x2", "3x3s2_on_5x5"])
def test_padfree_conv_count_equals_xla(k, stride, pad, size, cin, cout):
    """The padding-free count of one convolution, forward and backward
    (the gradients of input and weight), equals XLA's."""
    def conv(x, w):
        return jax.lax.conv_general_dilated(x, w, (stride, stride), ((pad, pad), (pad, pad)),
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    x, w = jnp.zeros((2, size, size, cin)), jnp.zeros((k, k, cin, cout))
    xla_fwd = _xla_flops(conv, x, w)
    xla_bwd = _xla_flops(jax.grad(lambda x, w: conv(x, w).sum(), argnums=(0, 1)), x, w)

    with torch.device("meta"):
        layer = torch.nn.Conv2d(cin, cout, k, stride, pad, bias=False)
        xt = torch.empty(2, cin, size, size, requires_grad=True)
    fwd, padded_fwd = bench._counter()
    with fwd:
        out = layer(xt)
    bwd, padded_bwd = bench._counter()
    with bwd:
        out.sum().backward()
    print(f"forward: XLA {xla_fwd:.0f}, dense {fwd.get_total_flops()}, "
          f"padding-free {fwd.get_total_flops() - padded_fwd[0]}")
    assert fwd.get_total_flops() - padded_fwd[0] == xla_fwd
    assert bwd.get_total_flops() - padded_bwd[0] == xla_bwd
    assert bwd.get_total_flops() == 2 * fwd.get_total_flops()


@pytest.mark.parametrize("img,agents", SHAPES, ids=[f"{s}px_{n}agents" for s, n in SHAPES])
def test_eval_step_flops_against_xla(img, agents):
    """bench.py:164-173's step (float32): XLA's count less its one-hot
    confusion matrix lies within EVAL_ELEMENTWISE above the port's
    padding-free count (module docstring)."""
    model, variables = _jax_model(img, agents, train=False)
    xs = jnp.zeros((1, agents, img, img, 3))
    ys = jnp.zeros((agents, img, img), jnp.int32)

    def eval_step(variables, x, labels):
        pred, _, _, _ = model.apply(variables, x, train=False, mo_flag=True,
                                    inference="activated")
        return jax_confusion_matrix(labels, jnp.argmax(pred, axis=-1), 11)

    xla = _xla_flops(eval_step, variables, xs, ys)
    xla_hist = _xla_flops(lambda t, p: jax_confusion_matrix(t, p, 11), ys, ys)
    dense, free = bench.count_flops(1, img, agents, False)
    excess = (xla - xla_hist) / free - 1
    print(f"eval {img}px x {agents}: XLA {xla:.0f} (histogram {xla_hist:.0f}), "
          f"port dense {dense} ({dense / xla:.4f}x XLA), padding-free {free}, "
          f"XLA's elementwise share {excess:.5f}")
    assert 0 <= excess <= EVAL_ELEMENTWISE


@pytest.mark.parametrize("img,agents", SHAPES, ids=[f"{s}px_{n}agents" for s, n in SHAPES])
def test_train_step_flops_against_xla(img, agents):
    """``bench_train``'s ``one_step`` (float32): XLA's count less its
    count of the Adam update alone lies within TRAIN_ELEMENTWISE above the
    port's padding-free count of the forward and backward."""
    model, variables = _jax_model(img, agents, train=True)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(1e-5)
    opt_state = tx.init(params)
    xs = jnp.zeros((1, agents, img, img, 3))
    ys = jnp.zeros((agents, img, img), jnp.int32)

    def one_step(params, stats, opt_state, images, labels):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, images,
                                   train=True, mo_flag=True, mutable=["batch_stats"])
            return jax_cross_entropy2d(out[0], labels), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, new_opt, loss

    def adam(params, grads, opt_state):
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_opt

    xla = _xla_flops(one_step, params, stats, opt_state, xs, ys)
    xla_adam = _xla_flops(adam, params, params, opt_state)
    dense, free = bench.count_flops(1, img, agents, True)
    excess = (xla - xla_adam) / free - 1
    print(f"train {img}px x {agents}: XLA {xla:.0f} (Adam {xla_adam:.0f}), "
          f"port dense {dense} ({dense / xla:.4f}x XLA), padding-free {free}, "
          f"XLA's elementwise share {excess:.5f}")
    assert 0 <= excess <= TRAIN_ELEMENTWISE


def _padded_tap_flops(train: bool, img: int = 64, agents: int = 2) -> int:
    """FLOPs of the convolution taps on padding in one step of the float32
    model, by hooks on a real CPU forward (and the backward's gradients)."""
    model = get_model(bench._config(img, agents), 11).train(train)
    total = [0]

    def hook(conv, args):
        x = args[0]
        kh, kw = conv.kernel_size
        mask = F.conv2d(torch.ones(1, 1, *x.shape[2:]), torch.ones(1, 1, kh, kw),
                        stride=conv.stride, padding=conv.padding, dilation=conv.dilation)
        taps = mask.numel() * kh * kw
        padded = 2 * x.shape[0] * conv.out_channels * conv.in_channels * \
            (taps - int(mask.sum()))
        total[0] += padded * (1 + (1 + x.requires_grad if train else 0))

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_pre_hook(hook)
    x = torch.randn(1, agents, img, img, 3)
    if train:
        model(x)
    else:
        with torch.no_grad():
            model(x, inference="activated")
    return total[0]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dense_gap_is_the_padded_taps(train):
    dense, free = bench.count_flops(1, 64, 2, train)
    print(f"{'train' if train else 'eval'}: dense / padding-free {dense / free:.4f}")
    assert dense - free == _padded_tap_flops(train) > 0


def test_kernels_take_their_plain_versions_on_meta():
    """The FLOP count's route: meta tensors go to K1's and K2's plain
    versions, which compute nothing there, and launch nothing."""
    before = (k1.upsample_argmax.launches, k2.comm_fusion.launches)
    with torch.device("meta"):
        for dtype in (torch.float32, torch.bfloat16):
            cls = k1.upsample_argmax(torch.empty(12, 11, 16, 16, dtype=dtype), 512, 512)
            assert cls.shape == (12, 512, 512) and cls.dtype == torch.int32
            q, k = torch.empty(2, 6, 1024, dtype=dtype), torch.empty(2, 6, 1024, dtype=dtype)
            fused, coef, soft = k2.comm_fusion(q, k, torch.empty(2, 6, 512, 16, 16, dtype=dtype),
                                               mode="activated", diag_bias=0.001)
            assert fused.shape == (2, 6, 512, 16, 16) and fused.dtype == dtype
            assert coef.shape == soft.shape == (2, 6, 6) and coef.device.type == "meta"
    assert (k1.upsample_argmax.launches, k2.comm_fusion.launches) == before


# ------------------------------------------------------------------ (c) the eval step

def test_eval_step_histogram_matches_jax():
    """``bench.eval_step`` (K2's and K1's plain versions on the CPU) against
    bench.py:164-173's step, on the bench's own seeded weights (carried
    into the JAX model) and inputs, at 128x128 with 3 agents in float32:
    the same total and at most 0.1% of the pixels elsewhere
    (tests/test_torch_eval.py's rule: K1's plain version resolves
    near-ties at the low resolution, the JAX step's argmax at full
    resolution). The seeded weights give a peaked graph, so ``activated``
    keeps links and the fusion does real work."""
    img, agents = 128, 3
    model = bench._build(img, agents, "float32", torch.device("cpu"))
    xs, ys = bench._inputs(1, img, agents, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        hist = bench.eval_step(model, xs, ys, torch.zeros(11, 11, dtype=torch.int64)).numpy()
        num_connect = float(model(xs, inference="activated", full_res=False)[3])

    jmodel, template = _jax_model(img, agents, train=False)
    variables = import_torch_state_dict(_jax_cfg(img, agents), 11, model.state_dict(),
                                        template)
    pred, _, _, jnc = jmodel.apply(variables, jnp.asarray(xs.numpy()), train=False,
                                   mo_flag=True, inference="activated")
    want = np.asarray(jax_confusion_matrix(jnp.asarray(ys.numpy().astype(np.int32)),
                                           jnp.argmax(pred, axis=-1), 11)).astype(np.int64)
    print(f"bandwidth port {num_connect} JAX {float(jnc)}; pixels elsewhere "
          f"{np.abs(hist - want).sum() // 2} of {want.sum()}")
    assert num_connect == pytest.approx(float(jnc), rel=1e-6) and num_connect > 0
    assert hist.sum() == want.sum() == agents * img * img
    assert np.abs(hist - want).sum() / 2 <= 0.001 * want.sum()
