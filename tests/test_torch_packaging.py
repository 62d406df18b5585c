"""Packaging rules of the PyTorch port: it imports neither ``jax`` nor the
JAX package (nor ``ml_dtypes``, which the card's machine lacks), and
``chip_smoke.py`` imports neither either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "analytics_zoo_tpu_torch"


def test_importing_every_port_module_leaves_jax_out():
    """A subprocess, because this test process already imported jax."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import analytics_zoo_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes'))\n"
        "print(json.dumps({'modules': mods, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "analytics_zoo_tpu_torch.serving.generation" in res["modules"]
    assert "analytics_zoo_tpu_torch.ops.paged_attention" in res["modules"]
    for mod in ("engine.estimator", "nn.optimizers", "nn.losses",
                "nn.topology", "ops.fused_ce", "common.config",
                "common.triggers", "data.featureset",
                "parallel.update_sharding", "ops.int8", "ops.int8_fused",
                "nn.graph", "nn.layers.core", "nn.layers.convolution",
                "nn.layers.merge", "inference.inference_model",
                "models.image.backbones", "models.image.classification",
                "common.chaos", "common.resilience", "common.summary",
                "engine.checkpoint", "data.pipeline", "nn.layers.recurrent",
                "models.recommendation.features",
                "models.recommendation.wide_and_deep",
                "models.recommendation.session_recommender",
                "common.telemetry", "common.locks", "observability",
                "observability.events", "observability.recorder",
                "observability.traces", "serving.qos", "inference.summary"):
        assert f"analytics_zoo_tpu_torch.{mod}" in res["modules"]


def test_the_serving_remainder_is_in_the_port():
    """The serving remainder's modules mirror the JAX package's paths; the
    walk above imports them without JAX, and the observability package
    exports only what the port has."""
    for rel in ("common/telemetry.py", "common/locks.py",
                "observability/events.py", "observability/recorder.py",
                "observability/traces.py", "serving/qos.py",
                "inference/summary.py"):
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    import analytics_zoo_tpu_torch.observability as obs

    assert set(obs.__all__) == {"FlightRecorder", "attach_jsonl", "emit",
                                "events", "export_trace", "recorder",
                                "reset_events", "trace_summaries", "traces"}
    assert all(hasattr(obs, name) for name in obs.__all__)


def test_the_ncf_slice_is_in_the_port():
    """The NCF slice's modules mirror the JAX package's paths, and the
    walk above (which imports every module of the port) reaches them."""
    for rel in ("common/prng.py", "data/datasets.py", "nn/metrics.py",
                "nn/layers/embedding.py", "models/common/zoo_model.py",
                "models/common/ranker.py",
                "models/recommendation/neuralcf.py",
                "models/recommendation/recommender.py"):
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file() or \
            rel == "common/prng.py", rel
    import analytics_zoo_tpu_torch.models.recommendation  # noqa: F401
    from analytics_zoo_tpu_torch.models.common import MODEL_REGISTRY

    assert {"NeuralCF", "ImplicitNCF"} <= set(MODEL_REGISTRY)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_port_or_chip_smoke_names_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {f.relative_to(PKG).as_posix() for f in files[:-1]}
    assert {"inference/inference_model.py", "models/image/backbones.py",
            "models/image/classification.py", "ops/int8.py",
            "ops/int8_fused.py", "nn/graph.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "analytics_zoo_tpu"), \
                f"{f.relative_to(ROOT)} imports {mod}"


def test_kernel_sources_ship_with_the_package():
    srcs = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"flash_fwd.cu", "flash_bwd.cu", "paged_attention.cu", "sample.cu",
            "int8_matmul.cu", "int8_conv.cu", "int8_tile.cuh",
            "zoo_cuda.cuh"} <= srcs
    from analytics_zoo_tpu_torch.ops import _build

    assert {"int8_matmul", "int8_conv"} <= set(_build.KERNELS)
    assert all((PKG / "csrc" / f"{k}.cu").is_file() for k in _build.KERNELS)
    text = (ROOT / "pyproject.toml").read_text()
    assert "csrc/*.cu" in text and "csrc/*.cuh" in text


DATA_PLANE = ("serving/wire.py", "serving/shm.py", "serving/schema.py",
              "serving/config.py", "serving/broker.py", "serving/client.py",
              "serving/slo_metrics.py", "serving/batching.py",
              "serving/hotswap.py", "serving/engine.py",
              "serving/http_frontend.py", "observability/debug.py")


def test_the_serving_data_plane_is_in_the_port_without_jax():
    """The data plane's modules mirror the JAX package's paths, and
    importing them (and the serving package) in a fresh interpreter pulls
    in neither JAX, the JAX package nor ml_dtypes."""
    for rel in DATA_PLANE:
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    mods = ["analytics_zoo_tpu_torch.serving"] + [
        "analytics_zoo_tpu_torch." + rel[:-3].replace("/", ".")
        for rel in DATA_PLANE]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from analytics_zoo_tpu_torch.serving import generation\n"
        "assert hasattr(generation, 'GenerationEngine')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
