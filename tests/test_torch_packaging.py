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
                "observability.traces", "serving.qos", "inference.summary",
                "analysis", "analysis.core", "analysis.trace",
                "analysis.graphlint", "analysis.memory", "analysis.astlint",
                "analysis.concurrency", "analysis.__main__",
                "analysis.rules", "analysis.rules.collectives",
                "analysis.rules.concurrency", "analysis.rules.decode",
                "analysis.rules.docs", "analysis.rules.fused_int8",
                "analysis.rules.graph_hygiene", "analysis.rules.memory",
                "common.memwitness"):
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

    import analytics_zoo_tpu.observability as jobs

    assert set(obs.__all__) == set(jobs.__all__)
    assert {"FlightRecorder", "attach_jsonl", "emit", "events",
            "export_trace", "recorder", "reset_events", "trace_summaries",
            "traces", "ObservabilityPlane", "MetricsHistory", "SLOEngine",
            "verify_incumbent"} <= set(obs.__all__)
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


CONTROL_PLANE = ("observability/history.py", "observability/slo.py",
                 "observability/replay.py", "serving/fleet.py",
                 "serving/hostagent.py", "serving/stack.py", "serving/cli.py",
                 "serving/rowcache.py")


def test_the_control_plane_is_in_the_port_without_jax():
    """The control plane's modules mirror the JAX package's paths, and the
    four entry points answer ``--help`` in a fresh interpreter that pulls in
    neither JAX, the JAX package nor ml_dtypes."""
    for rel in CONTROL_PLANE:
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    code = (
        "import contextlib, io, json, runpy, sys\n"
        "for m in ('stack', 'fleet', 'hostagent', 'cli'):\n"
        "    sys.argv = [m, '--help']\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        try:\n"
        "            runpy.run_module('analytics_zoo_tpu_torch.serving.' + m,"
        " run_name='__main__')\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (m, e.code)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_every_spawned_command_names_the_port():
    """The supervisor, the host agents' launcher and the CLI start
    ``python -m <module>`` subprocesses: every such module path is the
    port's, never the JAX package's, and each names a module that exists."""
    seen = set()
    for rel in ("serving/fleet.py", "serving/hostagent.py",
                "serving/cli.py", "serving/stack.py"):
        tree = ast.parse((PKG / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.List) and len(node.elts) >= 3 and \
                    isinstance(node.elts[1], ast.Constant) and \
                    node.elts[1].value == "-m":
                mod = node.elts[2]
                assert isinstance(mod, ast.Constant), (rel, ast.dump(mod))
                assert mod.value.startswith("analytics_zoo_tpu_torch."), \
                    (rel, mod.value)
                assert (ROOT / (mod.value.replace(".", "/") + ".py")
                        ).is_file(), mod.value
                seen.add(mod.value)
    assert seen == {"analytics_zoo_tpu_torch.serving.fleet",
                    "analytics_zoo_tpu_torch.serving.hostagent",
                    "analytics_zoo_tpu_torch.serving.broker"}


FILES_AND_SETS = ("common/context.py", "common/cluster.py",
                  "common/profiling.py", "data/tfrecord.py",
                  "data/xshards.py", "data/image.py", "data/image3d.py",
                  "data/text.py",
                  "models/textclassification/text_classifier.py")

#: JAX package modules that have no counterpart in the port, and why
NO_COUNTERPART = {
    "common/compat.py": "it only papers over moves in JAX's API "
                        "(shard_map, the Pallas compiler params); the port "
                        "has no such surface",
}


def test_the_files_and_sets_slice_is_in_the_port_without_jax():
    """The runtime context, cluster, profiling, file and set modules and
    TextClassifier mirror the JAX package's paths; importing them, and
    running the cluster worker's ``--help``, in a fresh interpreter pulls
    in neither JAX, the JAX package nor ml_dtypes (nor pandas, PIL or
    scipy, which only their readers and the 3D stages import)."""
    for rel in FILES_AND_SETS:
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    for rel in NO_COUNTERPART:
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
        assert not (PKG / rel).exists(), rel
    mods = ["analytics_zoo_tpu_torch." + rel[:-3].replace("/", ".")
            for rel in FILES_AND_SETS]
    code = (
        "import contextlib, importlib, io, json, runpy, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "sys.argv = ['cluster', '--help']\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    try:\n"
        "        runpy.run_module('analytics_zoo_tpu_torch.common.cluster',"
        " run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes', 'pandas', "
        "'PIL', 'scipy'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_cluster_launcher_spawns_the_port():
    """The launcher's default worker, and every ``-m`` module its source
    names, is the port's own module."""
    from analytics_zoo_tpu_torch.common import cluster

    launcher = cluster.ClusterLauncher(2, coordinator_port=1)
    argv = launcher.command()
    assert argv[1:] == ["-m", "analytics_zoo_tpu_torch.common.cluster"]
    assert (ROOT / (argv[2].replace(".", "/") + ".py")).is_file()
    tree = ast.parse((PKG / "common/cluster.py").read_text())
    named = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and isinstance(n.value, str)
             and n.value.startswith("analytics_zoo_tpu")]
    assert named and all(v.startswith("analytics_zoo_tpu_torch.")
                         for v in named)


ANALYSIS = ("analysis/core.py", "analysis/graphlint.py", "analysis/memory.py",
            "analysis/astlint.py", "analysis/concurrency.py",
            "analysis/__main__.py", "analysis/rules/collectives.py",
            "analysis/rules/concurrency.py", "analysis/rules/decode.py",
            "analysis/rules/docs.py", "analysis/rules/fused_int8.py",
            "analysis/rules/graph_hygiene.py", "analysis/rules/memory.py",
            "common/memwitness.py")


def test_the_analysis_tier_is_in_the_port_without_jax():
    """The analysis modules and the memory witness mirror the JAX
    package's paths (the trace recorder, ``analysis/trace.py``, is the
    port's own), and the CLI lists its rules in a fresh interpreter that
    pulls in neither JAX, the JAX package nor ml_dtypes."""
    for rel in ANALYSIS:
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    assert (PKG / "analysis" / "trace.py").is_file()
    code = (
        "import contextlib, io, json, runpy, sys\n"
        "sys.argv = ['analysis', '--list-rules']\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    try:\n"
        "        runpy.run_module('analytics_zoo_tpu_torch.analysis',"
        " run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code in (0, None), e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes'))\n"
        "print(json.dumps({'bad': bad, 'rules': len(buf.getvalue()"
        ".splitlines())}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "rules": 23}


TEXT_SLICE = ("models/text/__init__.py", "models/text/bert_classifier.py",
              "models/text/bert_estimators.py",
              "models/text/sequence_models.py",
              "models/textmatching/__init__.py", "models/textmatching/knrm.py",
              "models/textmatching/text_matcher.py",
              "models/anomalydetection/__init__.py",
              "models/anomalydetection/anomaly_detector.py")


def test_the_text_slice_is_in_the_port_without_jax():
    """The text models mirror the JAX package's paths, and a fresh
    interpreter that imports them, the attention layers and the zoo
    registry's every entry pulls in neither JAX, the JAX package nor
    ml_dtypes."""
    for rel in TEXT_SLICE:
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    code = (
        "import json, sys\n"
        "from analytics_zoo_tpu_torch.nn.layers import (BERT, "
        "MultiHeadAttention, PositionalEmbedding, TransformerLayer)\n"
        "from analytics_zoo_tpu_torch.models.common.zoo_model import "
        "registered_model\n"
        "names = ['BERTClassifier', 'BERTNER', 'BERTSQuAD', 'NER', "
        "'SequenceTagger', 'IntentEntity', 'KNRM', 'AnomalyDetector', "
        "'TransformerLM', 'PipelinedTransformerLM']\n"
        "found = [n for n in names if registered_model(n) is not None]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes'))\n"
        "print(json.dumps({'bad': bad, 'found': found}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and len(res["found"]) == 10, res


def test_the_detection_seq2seq_gan_and_importer_slice_is_in_the_port():
    """SSD, Seq2seq, the GAN trainer and the eight importers mirror the
    JAX package's paths and load in a fresh interpreter with none of
    ``jax``, the JAX package, ``ml_dtypes``, ``h5py`` or ``tensorflow``
    (the card's machine has neither of the last two)."""
    rels = ["models/image/objectdetection.py", "models/seq2seq/__init__.py",
            "models/seq2seq/seq2seq.py", "engine/gan.py"] + [
        f"importers/{m}.py" for m in ("__init__", "onnx_proto",
                                      "onnx_loader", "torch_loader",
                                      "keras_h5", "tf_proto", "tf_net",
                                      "caffe", "net")]
    for rel in rels:
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    mods = [("analytics_zoo_tpu_torch." + r[:-3].replace("/", "."))
            .removesuffix(".__init__") for r in rels]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from analytics_zoo_tpu_torch.engine import GANEstimator\n"
        "from analytics_zoo_tpu_torch.models.image import ObjectDetector\n"
        "from analytics_zoo_tpu_torch.importers import Net\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes', 'h5py', "
        "'tensorflow'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


ORCA_SLICE = ("orca/__init__.py", "orca/task_pool.py", "orca/rl.py",
              "orca/learn/__init__.py", "orca/learn/estimator.py",
              "nnframes/__init__.py", "nnframes/nn_estimator.py",
              "nnframes/nn_image_reader.py", "nnframes/xgb.py",
              "automl/__init__.py", "automl/space.py", "automl/metrics.py",
              "automl/tpe.py", "automl/feature.py", "automl/models.py",
              "automl/search.py", "automl/recipe.py", "automl/pipeline.py",
              "automl/predictor.py", "zouwu/__init__.py",
              "zouwu/model/__init__.py", "zouwu/model/forecast.py",
              "zouwu/model/anomaly.py", "zouwu/autots/__init__.py",
              "zouwu/autots/forecast.py")


def test_orca_nnframes_automl_zouwu_are_in_the_port_without_their_extras():
    """The four packages mirror the JAX package's paths and public names,
    and import in a fresh interpreter that loads none of JAX, the JAX
    package, pandas, scikit-learn, cloudpickle, PIL or xgboost (each is
    imported inside the function that needs it)."""
    for rel in ORCA_SLICE:
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    pkgs = ("orca", "orca.learn", "nnframes", "automl", "zouwu",
            "zouwu.model", "zouwu.autots")
    code = (
        "import importlib, json, sys\n"
        f"alls = {{p: sorted(importlib.import_module("
        f"'analytics_zoo_tpu_torch.' + p).__all__) for p in {pkgs!r}}}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes', 'pandas', "
        "'sklearn', 'cloudpickle', 'PIL', 'xgboost'))\n"
        "print(json.dumps({'bad': bad, 'alls': alls}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    import importlib

    for p, names in res["alls"].items():
        jax_mod = importlib.import_module("analytics_zoo_tpu." + p)
        assert names == sorted(jax_mod.__all__), p
    from analytics_zoo_tpu.automl import models as jmodels
    from analytics_zoo_tpu_torch.automl import models as tmodels

    assert set(tmodels.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)


def test_task_pool_workers_spawn_the_port():
    """A TaskPool's workers are ``spawn``ed processes whose target is the
    port's own worker loop (the child imports it by that module name),
    and every module name the pool's source spells is the port's."""
    from analytics_zoo_tpu_torch.orca import task_pool

    assert task_pool._worker_main.__module__ == \
        "analytics_zoo_tpu_torch.orca.task_pool"
    tree = ast.parse((PKG / "orca/task_pool.py").read_text())
    named = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and isinstance(n.value, str)
             and n.value.startswith("analytics_zoo_tpu")]
    assert named and all(v.startswith("analytics_zoo_tpu_torch")
                         for v in named)
    assert '"spawn"' in (PKG / "orca/task_pool.py").read_text()


def _modules(pkg: Path):
    return {p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")
            if p.name != "__init__.py" and "__pycache__" not in p.parts}


def _packages(pkg: Path):
    return {p.parent.relative_to(pkg).as_posix()
            for p in pkg.rglob("__init__.py")}


def test_every_jax_module_has_a_counterpart_but_compat():
    """The two module trees compared (``__init__.py`` aside): every JAX
    module and package has its counterpart in the port, but the modules
    of NO_COUNTERPART, so a JAX module added without one fails here."""
    jax_pkg = ROOT / "analytics_zoo_tpu"
    assert _modules(jax_pkg) - _modules(PKG) == set(NO_COUNTERPART)
    assert _packages(jax_pkg) - _packages(PKG) == set()


def test_the_tile_table_native_runtime_and_keras2_import_without_jax():
    """``ops/tuning.py``, ``native/`` (with its own copy of the C++
    source) and ``keras2/`` mirror the JAX package's paths and names, and
    import in a fresh interpreter without JAX, the JAX package or
    ml_dtypes."""
    for rel in ("ops/tuning.py", "native/lib.py", "native/__init__.py",
                "keras2/__init__.py"):
        assert (PKG / rel).is_file(), rel
        assert (ROOT / "analytics_zoo_tpu" / rel).is_file(), rel
    assert (PKG / "csrc" / "zoo_native.cpp").is_file()
    assert "csrc/*.cpp" in (ROOT / "pyproject.toml").read_text()
    code = (
        "import importlib, json, sys\n"
        "mods = ['ops.tuning', 'native', 'native.lib', 'keras2']\n"
        "alls = {m: sorted(getattr(importlib.import_module("
        "'analytics_zoo_tpu_torch.' + m), '__all__', [])) for m in mods}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'analytics_zoo_tpu', 'ml_dtypes'))\n"
        "print(json.dumps({'bad': bad, 'alls': alls}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    import importlib

    for m in ("native", "keras2"):
        assert res["alls"][m] == sorted(
            importlib.import_module("analytics_zoo_tpu." + m).__all__), m
    from analytics_zoo_tpu.ops import tuning as jtuning
    from analytics_zoo_tpu_torch.ops import tuning

    public = {n for n in dir(jtuning) if not n.startswith("_")
              and callable(getattr(jtuning, n))
              and getattr(getattr(jtuning, n), "__module__", "")
              == jtuning.__name__}
    assert public <= set(dir(tuning)), public - set(dir(tuning))


def _raised_texts(tree: ast.AST):
    """``(line, text)`` of every ``raise NotImplementedError(...)``: the
    string parts of its arguments, f-strings' literal parts included."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        call = node.exc
        func = call.func if isinstance(call, ast.Call) else call
        if getattr(func, "id", getattr(func, "attr", "")) != \
                "NotImplementedError":
            continue
        parts = [c.value for c in ast.walk(call)
                 if isinstance(c, ast.Constant) and isinstance(c.value, str)]
        yield node.lineno, " ".join(parts)


def test_no_refusal_of_the_port_cites_a_roadmap_item():
    """The port is complete: no ``NotImplementedError`` it raises points at
    ROADMAP or a Queue label (``Queue 1``, ``[13]``) as work still to
    port. The importers' refusals of an op stay: they name an op the JAX
    importers refuse too."""
    import re

    label = re.compile(r"ROADMAP|Queue\s*\d|\[\d+\]")
    found, n_raises = [], 0
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for line, text in _raised_texts(tree):
            n_raises += 1
            if label.search(text):
                found.append(f"{path.relative_to(ROOT)}:{line}: {text}")
    assert n_raises > 0                  # the scan sees the refusals
    assert found == []
