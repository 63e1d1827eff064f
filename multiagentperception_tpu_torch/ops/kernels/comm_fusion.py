"""The fused when2com communication step: MIMOcom's eval kernel (K2).

Port of the TPU kernel ``multiagentperception_tpu/ops/pallas/comm_fusion.py``
(``fused_comm_step``). Per batch element: logits = K Q'^T, softmax over
keys, + ``diag_bias`` I (the pre-mask graph ``soft``), the mode mask
(``softmax`` | ``activated`` strict ``> thres`` | ``argmax`` one-hot,
lowest key on ties) giving ``coef``, and fused = coef^T V. As the TPU
kernel does (comm_fusion.py:42-43, 63-67), Q', K and V are read in their
dtype (float32, bfloat16 or float16) and upcast, the graph and the fusion
are float32, ``coef`` and ``soft`` are float32, and ``fused`` is rounded once
to V's dtype. On CUDA tensors ``comm_fusion`` launches
``csrc/comm_fusion.cu`` (entry point ``comm_fusion_f32``,
``comm_fusion_bf16`` or ``comm_fusion_f16``, counted in
``comm_fusion.route_launches``); on CPU tensors it runs
``comm_fusion_plain``, the same function in plain PyTorch, and so it does
on ``meta`` tensors, which compute nothing (the bench counts the model's
FLOPs on them). ``plan`` picks the kernel's design by the agent count: the
cluster design up to ``CLUSTER_AGENTS`` (16) agents, the wide design above,
for any N (``comm_fusion.design_launches`` counts each; one launch of the
wrapper is one call, whatever the design). On CPU and CUDA tensors the
wrapper calls the custom op ``when2com::comm_fusion`` (``torch.library``):
its CPU implementation is the plain version, its CUDA one the launch
(which counts), and its fake one only allocates the three outputs, so
``torch.export`` keeps the op as one node of the graph.
"""

from __future__ import annotations

import ctypes

import torch

from multiagentperception_tpu_torch.ops.comm import fuse_values, one_hot_argmax
from multiagentperception_tpu_torch.ops.kernels import _build

MODES = ("softmax", "activated", "argmax")
CLUSTER_AGENTS = 16  # kMaxAgents in csrc/comm_fusion.cu: the cluster design's most
DESIGNS = ("cluster", "wide")
MAX_GRID_Y = 65535  # the CUDA grid's y and z extents: batch elements
# dtype: (route, C entry point, elements of V in one 16-byte load)
ROUTES = {torch.float32: ("f32", "comm_fusion_f32", 4),
          torch.bfloat16: ("bf16", "comm_fusion_bf16", 8),
          torch.float16: ("f16", "comm_fusion_f16", 8)}


def comm_fusion_plain(query_proj: torch.Tensor, keys: torch.Tensor,
                      vals: torch.Tensor, mode: str = "softmax",
                      diag_bias: float = 0.0, thres: float = 0.2):
    """Plain PyTorch version: returns (fused, coef, soft) like the kernel.
    Float64 inputs stay float64; any other dtype is upcast to float32 first
    and ``fused`` rounded once to V's dtype."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    work = torch.promote_types(vals.dtype, torch.float32)
    logits = torch.einsum("bkd,bqd->bkq", keys.to(work), query_proj.to(work))
    soft = torch.softmax(logits, dim=1)
    if diag_bias:
        n = soft.shape[1]
        soft = soft + diag_bias * torch.eye(n, dtype=soft.dtype, device=soft.device)
    if mode == "activated":
        coef = torch.where(soft > thres, soft, torch.zeros_like(soft))
    elif mode == "argmax":
        coef = one_hot_argmax(soft, dim=1)
    else:  # a tensor of its own: the op's outputs may not alias each other
        coef = soft.clone()
    return fuse_values(coef, vals.to(work)).to(vals.dtype), coef, soft


def comm_fusion(query_proj: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                mode: str = "softmax", diag_bias: float = 0.0, thres: float = 0.2):
    """query_proj (B, N, D) (already through the attention's linear W),
    keys (B, N, D), vals (B, N, *rest) -> (fused like vals, coef (B, N, N),
    soft (B, N, N)); coef/soft are ``[b, key, query]``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if vals.device.type == "meta":
        return comm_fusion_plain(query_proj, keys, vals, mode, diag_bias, thres)
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vals.device}")
    return OP(query_proj, keys, vals, mode, float(diag_bias), float(thres))


@torch.library.custom_op("when2com::comm_fusion", mutates_args=(), device_types="cpu")
def comm_fusion_op(query_proj: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                   mode: str, diag_bias: float,
                   thres: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CPU implementation: the plain version."""
    return comm_fusion_plain(query_proj, keys, vals, mode, diag_bias, thres)


@comm_fusion_op.register_fake
def _fake(query_proj, keys, vals, mode, diag_bias, thres):
    b, n = vals.shape[:2]
    graph = vals.new_empty((b, n, n), dtype=torch.promote_types(vals.dtype, torch.float32))
    return torch.empty_like(vals), graph, torch.empty_like(graph)


def plan(b: int, n: int, d: int, m: int, dtype: torch.dtype) -> str:
    """The design of the kernel for ``b`` batch elements of ``n`` agents,
    keys of ``d`` and value rows of ``m`` elements of ``dtype``:
    ``"cluster"`` (clusters of CTAs sharing one graph through distributed
    shared memory, up to CLUSTER_AGENTS agents) or ``"wide"`` (a graph
    kernel and a fusion kernel, any number of agents). Raises on what
    neither takes."""
    if dtype not in ROUTES:
        raise TypeError(f"comm_fusion kernel takes float32, bfloat16 or float16, got {dtype}")
    if not (0 < b <= MAX_GRID_Y) or n <= 0 or d <= 0 or m <= 0:
        raise ValueError(f"comm_fusion kernel: unsupported B={b}, N={n}, D={d}, M={m}")
    pack = ROUTES[dtype][2]
    if m % pack:
        raise ValueError(f"comm_fusion kernel streams {dtype} V in 16-byte loads of "
                         f"{pack}: needs M % {pack} == 0 and a 16-byte aligned V (M={m})")
    return "cluster" if n <= CLUSTER_AGENTS else "wide"


def _launch(query_proj, keys, vals, mode, diag_bias, thres):
    """The op's CUDA implementation: the kernel, or an error."""
    for name, t in (("query_proj", query_proj), ("keys", keys), ("vals", vals)):
        if t.device != vals.device:
            raise ValueError(f"{name} on {t.device}, vals on {vals.device}")
        if t.dtype != vals.dtype or t.dtype not in ROUTES:
            raise TypeError(f"comm_fusion kernel takes query_proj, keys and vals all "
                            f"float32, all bfloat16 or all float16; {name} is {t.dtype}, "
                            f"vals {vals.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"comm_fusion kernel takes contiguous tensors; {name} is not")
    if vals.dim() < 2 or query_proj.dim() != 3 or keys.dim() != 3:
        raise ValueError("expected query_proj/keys (B, N, D) and vals (B, N, ...)")
    b, n = vals.shape[:2]
    d = keys.shape[2]
    if query_proj.shape != (b, n, d) or keys.shape != (b, n, d):
        raise ValueError(f"shape mismatch: query_proj {tuple(query_proj.shape)}, "
                         f"keys {tuple(keys.shape)}, vals {tuple(vals.shape)}")
    m = vals[0, 0].numel() if b and n else 0
    design = plan(b, n, d, m, vals.dtype)
    route, entry, pack = ROUTES[vals.dtype]
    if vals.data_ptr() % 16:
        raise ValueError(f"comm_fusion kernel streams {vals.dtype} V in 16-byte loads of "
                         f"{pack}: needs M % {pack} == 0 and a 16-byte aligned V (M={m})")
    fused = torch.empty_like(vals)
    coef = torch.empty((b, n, n), dtype=torch.float32, device=vals.device)
    soft = torch.empty_like(coef)
    lib = _build.load("comm_fusion")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = getattr(lib, entry)(
            query_proj.data_ptr(), keys.data_ptr(), vals.data_ptr(),
            fused.data_ptr(), coef.data_ptr(), soft.data_ptr(), b, n, d, m,
            MODES.index(mode), float(diag_bias), float(thres),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"comm_fusion kernel launch failed: CUDA error {rc}")
    comm_fusion.route_launches[route] += 1
    comm_fusion.design_launches[design] += 1
    comm_fusion.launches += 1
    return fused, coef, soft


# registered straight with the dispatcher, as K1's (upsample_argmax.py)
torch.library.impl("when2com::comm_fusion", "cuda", _launch)
OP = torch.ops.when2com.comm_fusion.default  # what the wrapper calls

comm_fusion.launches = 0
comm_fusion.route_launches = {route: 0 for route, _, _ in ROUTES.values()}
comm_fusion.design_launches = dict.fromkeys(DESIGNS, 0)
# the device kernels of one call (csrc names), with 1 where the kernel runs
# once a call on its own design's path: a trace counts calls by those
comm_fusion.device_kernels = {"comm_fusion_kernel": 1, "comm_fusion_wide_graph": 0,
                              "comm_fusion_wide_fuse": 1}
