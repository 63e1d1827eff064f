"""The port stands alone: it imports neither JAX nor the JAX package, nor PIL
or grain (neither is in the contract of the card's machine), its native
decoder builds inside the package's build directory, and its entry points
run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "multiagentperception_tpu_torch"
FLAGSHIP = ROOT / "configs" / "multi-request-multi-support" / "mrms_when2com.yml"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "multiagentperception_tpu"}
NOT_IN_CONTRACT = {"PIL", "grain"}  # absent from the card's machine's contract


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import json, sys\n"
        "import multiagentperception_tpu_torch, multiagentperception_tpu_torch.test\n"
        "import multiagentperception_tpu_torch.evaluate, multiagentperception_tpu_torch.convert\n"
        "import multiagentperception_tpu_torch.ops.kernels.upsample_argmax\n"
        "import multiagentperception_tpu_torch.ops.kernels.comm_fusion\n"
        "import multiagentperception_tpu_torch.ops.kernels.fused_block\n"
        "import multiagentperception_tpu_torch.data, multiagentperception_tpu_torch.train\n"
        "import multiagentperception_tpu_torch.trainer, multiagentperception_tpu_torch.loss\n"
        "import multiagentperception_tpu_torch.optimizers\n"
        "import multiagentperception_tpu_torch.schedulers\n"
        "import multiagentperception_tpu_torch.bench_fused_block\n"
        "import multiagentperception_tpu_torch.bench\n"
        "import multiagentperception_tpu_torch.quantize, multiagentperception_tpu_torch.export\n"
        "import multiagentperception_tpu_torch.ops.kernels.int8_conv\n"
        "import multiagentperception_tpu_torch.data.grain_pipeline\n"
        "import multiagentperception_tpu_torch.data.augmentations\n"
        "import multiagentperception_tpu_torch.native\n"
        "import multiagentperception_tpu_torch.bench_train_pipeline\n"
        "import multiagentperception_tpu_torch.validate_dataset\n"
        "import multiagentperception_tpu_torch.bench_eval_pipeline\n"
        "import multiagentperception_tpu_torch.prove_learning\n"
        "import multiagentperception_tpu_torch.run_flagship_512\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "multiagentperception_tpu_torch.evaluate" in loaded
    assert "multiagentperception_tpu_torch.trainer" in loaded
    assert "multiagentperception_tpu_torch.bench" in loaded
    assert "multiagentperception_tpu_torch.quantize" in loaded
    assert "multiagentperception_tpu_torch.run_flagship_512" in loaded
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN_ROOTS | NOT_IN_CONTRACT]
    assert not bad, f"the port pulled in {bad}"


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_pil_or_grain(path):
    assert not _imported_roots(path) & NOT_IN_CONTRACT, path


def test_native_build_writes_only_under_the_build_dir(tmp_path):
    """A copy of ``native.py`` and ``csrc/decoder.cpp`` in a fresh package
    tree, built from another directory with its own TMPDIR: every new file
    lies under the copy's ``build/`` (the compiler's temporaries too), and the
    library it leaves there loads and decodes."""
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    shutil.copy(PORT / "native.py", pkg / "native.py")
    shutil.copy(PORT / "csrc" / "decoder.cpp", pkg / "csrc" / "decoder.cpp")
    cwd, tmp = tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    before = {p for p in tmp_path.rglob("*")}
    code = (f"import sys; sys.path.insert(0, {str(pkg)!r}); import native; "
            "print(native.build()); print(native.available())")
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "TMPDIR": str(tmp),
                                           "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stderr
    lib, ok = out.stdout.split()
    assert ok == "True" and Path(lib).parent == pkg / "build" / "native"
    new = {p for p in tmp_path.rglob("*") if p.is_file()} - before
    assert new == {Path(lib)}, new


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN_ROOTS, f"{path}: imports {name}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_never_calls_tensor_cuda(path):
    """``.cuda()`` is avoided: the JAX package's torch harness patches
    ``torch.Tensor.cuda`` to a no-op for the whole process, so in a test
    worker that ran it, ``.cuda()`` would silently leave tensors on the CPU."""
    tree = ast.parse(path.read_text(), filename=str(path))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "cuda"]
    assert not calls, f"{path}: .cuda() at lines {[n.lineno for n in calls]}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_card(no_card):
    from multiagentperception_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_evaluator_defaults_to_the_card(no_card):
    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.evaluate import Evaluator

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(load_config(str(FLAGSHIP)))


def test_cli_defaults_to_the_card(no_card, tmp_path):
    from multiagentperception_tpu_torch import test as cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(FLAGSHIP), "--model_path", str(tmp_path / "x.pkl")])


def test_train_cli_defaults_to_the_card(no_card):
    from multiagentperception_tpu_torch import train as cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(FLAGSHIP)])


def test_bench_fused_block_needs_the_card(no_card):
    from multiagentperception_tpu_torch import bench_fused_block as bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """No card here: the smoke script exits non-zero and prints no result,
    and so it does from a directory that holds nothing else of the repo."""
    lone = tmp_path / "lone"
    lone.mkdir()
    (lone / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    runs = [(lone, lone / "chip_smoke.py")]
    if not torch.cuda.is_available():  # with a card, the full smoke would run
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_unported_configs_raise_not_implemented():
    """Named for the refusal it once held: the topk YAML with
    ``model.dtype: float16`` builds, computing in float16 over float32
    parameters (its forwards: tests/test_torch_float16*.py)."""
    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.models import get_model
    from multiagentperception_tpu_torch.models.blocks import Conv2d, Linear

    cfg = load_config(str(ROOT / "configs" / "extensions" / "mrms_when2com_topk.yml"))
    cfg["model"]["dtype"] = "float16"
    model = get_model(cfg, 11)
    assert model.topk_k == cfg["model"]["topk_k"]
    assert {m.compute_dtype for m in model.modules()
            if isinstance(m, (Conv2d, Linear))} == {torch.float16}
    assert all(v.dtype == torch.float32 for v in model.state_dict().values()
               if v.is_floating_point())


def test_serving_modules_load_no_jax_module():
    code = (
        "import json, sys\n"
        "import multiagentperception_tpu_torch.export_serving\n"
        "import multiagentperception_tpu_torch.serve\n"
        "import multiagentperception_tpu_torch.visual\n"
        "import multiagentperception_tpu_torch.visualize\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "multiagentperception_tpu_torch.visual" in loaded
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"the port pulled in {bad}"


def test_importing_the_kernels_registers_every_op_without_the_models():
    code = (
        "import json, sys, torch\n"
        "import multiagentperception_tpu_torch.ops.kernels as kernels\n"
        "ops = [hasattr(getattr(torch.ops.when2com, n), 'default') for n in kernels.OPS]\n"
        "print(json.dumps([ops, sorted(sys.modules)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    ops, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert ops == [True] * 4
    assert not [m for m in loaded if m.startswith("multiagentperception_tpu_torch.models")]


@pytest.mark.parametrize("cli", ["export_serving", "serve", "visualize"])
def test_serving_clis_default_to_the_card(no_card, cli, tmp_path):
    import importlib

    main = importlib.import_module(f"multiagentperception_tpu_torch.{cli}").main
    args = {"export_serving": ["--config", str(FLAGSHIP), "--out", str(tmp_path / "m.pt2")],
            "serve": ["--config", str(FLAGSHIP), "--artifact", str(tmp_path / "m.pt2")],
            "visualize": ["--config", str(FLAGSHIP), "--model_path", str(tmp_path / "x.pkl")]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args[cli])


@pytest.mark.parametrize("entry", ["bench_eval_pipeline", "prove_learning", "run_flagship_512"])
def test_user_runs_default_to_the_card(no_card, entry, tmp_path):
    """The scripts/ counterparts: each raises before it writes or trains anything."""
    import importlib

    module = importlib.import_module(f"multiagentperception_tpu_torch.{entry}")
    run = {"bench_eval_pipeline": lambda: module.main(),
           "prove_learning": lambda: module.main(iters=1, root=str(tmp_path / "data")),
           "run_flagship_512": lambda: module.main(["--root", str(tmp_path / "data"),
                                                    "--workdir", str(tmp_path / "w")])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run[entry]()
    assert not list(tmp_path.iterdir())
