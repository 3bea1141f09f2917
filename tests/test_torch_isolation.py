"""The port stands alone: importing every repro_torch module (and chip_smoke.py)
pulls in neither jax nor the JAX package, no line of the port or its scripts
imports either, and the kernel path has no fallback handlers."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_import_only")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert {
        "repro_torch.compat", "repro_torch.core.ordering", "repro_torch.kernels.segment_rf",
        "repro_torch.kernels._build", "repro_torch.graphs.engine", "repro_torch.elastic.rescale_exec",
        "repro_torch.obs.trace", "repro_torch.launch.sharding", "repro_torch.kernels.edge_spmv",
        "repro_torch.kernels.flash_attention", "repro_torch.kernels.decode_attention",
        "repro_torch.kernels.span_reorder", "repro_torch.kernels.full_reorder", "repro_torch.kernels.rescale_migrate",
        "repro_torch.kernels.packed_sort", "repro_torch.stream",
        "repro_torch.stream.updates", "repro_torch.stream.incremental", "repro_torch.stream.workload",
        "repro_torch.stream.ingest", "repro_torch.launch.mesh", "repro_torch.launch.multihost",
        "repro_torch.obs.metrics", "repro_torch.data", "repro_torch.data.shards", "repro_torch.data.pipeline",
        "repro_torch.core.hier_order", "repro_torch.stream.spill",
        "repro_torch.elastic.controller", "repro_torch.elastic.autoscale", "repro_torch.elastic.resharder",
        "repro_torch.elastic.expert_place", "repro_torch.checkpoint", "repro_torch.checkpoint.store",
        "repro_torch.obs.log", "repro_torch.obs.trace_export", "repro_torch.launch.serve",
        "repro_torch.models", "repro_torch.models.config", "repro_torch.models.dist", "repro_torch.models.layers",
        "repro_torch.models.model", "repro_torch.configs", "repro_torch.configs.phi3_vision",
        "repro_torch.configs.gemma3_4b", "repro_torch.configs.qwen3_8b", "repro_torch.configs.qwen2_1_5b",
        "repro_torch.configs.gemma2_9b", "repro_torch.configs.whisper_small", "repro_torch.configs.mamba2_1_3b",
        "repro_torch.configs.deepseek_moe_16b", "repro_torch.configs.granite_moe_3b", "repro_torch.configs.hymba_1_5b",
        "repro_torch.train", "repro_torch.train.optimizer", "repro_torch.train.steps", "repro_torch.launch.train",
        "repro_torch.train.compression", "repro_torch.launch.specs", "repro_torch.launch.roofline",
        "repro_torch.launch.dryrun",
    } <= set(result["modules"])


_SERVE_PROBE = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv[2])
import torch_serve_harness
torch_serve_harness.port_modules()
runpy.run_path(sys.argv[1], run_name="serve_path_import_only")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
print(json.dumps({"bad": bad, "serve": "repro_torch.launch.serve" in sys.modules}))
"""


def test_serve_path_and_its_harness_load_no_jax():
    """``tools/serve_path.py`` and the harness its ranks run
    (``tests/torch_serve_harness.py``) stand on the port alone."""
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_PROBE, str(ROOT / "tools" / "serve_path.py"), str(ROOT / "tests")],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "serve": True}


def test_no_source_line_imports_jax_or_the_reference():
    """Three tools are the exceptions: they run the JAX package on the CPU,
    ``tools/lm_fixture.py`` and ``tools/train_fixture.py`` to write the
    fixtures that paths 10 (c) and 11 (c) read, ``tools/lm_bf16_parity.py`` to
    hold the port's bf16 forward to the reference's."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    exempt = {"lm_fixture.py", "train_fixture.py", "lm_bf16_parity.py"}
    tools = [f for f in sorted((ROOT / "tools").glob("*.py")) if f.name not in exempt]
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + tools
    files += [ROOT / "tests" / "torch_serve_harness.py", ROOT / "tests" / "torch_lm_harness.py"]
    hits = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert hits == []


def test_no_exception_handler_on_the_kernel_path():
    files = [PORT / "kernels" / n for n in ("_build.py", "segment_rf.py", "ops.py", "edge_spmv.py",
                                             "flash_attention.py", "decode_attention.py", "span_reorder.py",
                                             "full_reorder.py", "rescale_migrate.py", "packed_sort.py")]
    files += sorted((PORT / "stream").glob("*.py")) + [PORT / "core" / "hier_order.py"]
    files += [PORT / "graphs" / "engine.py", PORT / "elastic" / "rescale_exec.py", ROOT / "chip_smoke.py"]
    files += sorted((PORT / "models").glob("*.py")) + [ROOT / "tests" / "torch_lm_harness.py"]
    files += sorted((PORT / "train").glob("*.py")) + [PORT / "launch" / "train.py"]
    files += [PORT / "launch" / n for n in ("mesh.py", "sharding.py", "specs.py", "roofline.py", "dryrun.py")]
    hits = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if re.match(r"^\s*(try|except)\b", line)]
    assert hits == []
