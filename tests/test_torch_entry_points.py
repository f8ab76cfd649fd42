"""Every entry point of the repo that drives the JAX package is classed:
each root ``*.py`` and each file under ``scripts/`` that names
``toybox_tpu`` (not ``toybox_tpu_torch``) either has a counterpart in
PORTED, a file that exists and imports neither ``jax`` nor
``toybox_tpu``, or stands in EXEMPT with the reason it is not ported. A
new JAX-only script fails here until it is classed."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX package by name: not toybox_tpu_torch, not a path into it
NAMES_JAX = re.compile(r"(?<![\w/])toybox_tpu(?![\w/])")
FORBIDDEN = ("jax", "flax", "msgpack", "toybox_tpu")

#: JAX entry point -> the port's counterpart
PORTED = {
    "bench.py": "bench_torch.py",
    "scripts/ppo_step_timing.py": "scripts/port_ppo_step_timing.py",
    "scripts/behavior_matrix.py": "scripts/port_behavior_matrix.py",
    "scripts/start_images.py": "scripts/port_start_images.py",
    "scripts/benchmark.sh": "scripts/port_benchmark.sh",
    "scripts/regress.sh": "scripts/port_regress.sh",
    "scripts/behavior_tests.sh": "scripts/port_behavior_tests.sh",
    "scripts/train_all.sh": "scripts/port_train_all.sh",
    "scripts/unit_tests.sh": "scripts/port_unit_tests.sh",
}

#: JAX entry points (a directory ends in "/") not ported, and why
EXEMPT = {
    "scripts/tpu_smoke.py": "chip_smoke.py phases 3-4 take its place",
    "scripts/tpu_parity_check.py": "chip_smoke.py phases 3-4 take its "
                                   "place",
    "scripts/distributed_smoke.py": "chip_smoke.py phase 22(b)",
    "scripts/pipe_timing.py": "bench_torch.bench_pipeline and chip_smoke.py "
                              "phase 3",
    "scripts/breakout_step_profile.py": "it guts the JAX step's internals; "
                                        "chip_smoke.py phase 7's per-kernel "
                                        "profile takes its place",
    "__graft_entry__.py": "the TPU entry point; chip_smoke.py takes its "
                          "place, and phase 22(a) runs dryrun_multichip(1)",
    "scripts/cluster/": "TPU-pod operations",
    "scripts/cron/": "TPU-pod operations",
    "scripts/gate_vs_jax.py": "it drives both packages by design",
}


def _entry_points():
    files = sorted(ROOT.glob("*.py")) + sorted(
        p for p in (ROOT / "scripts").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts)
    return [str(p.relative_to(ROOT)) for p in files]


def _exempt(rel: str):
    return next((why for key, why in EXEMPT.items()
                 if rel == key or (key.endswith("/") and rel.startswith(key))),
                None)


@pytest.mark.parametrize("rel", [r for r in _entry_points() if
                                 NAMES_JAX.search((ROOT / r).read_text())])
def test_jax_entry_point_is_classed(rel):
    assert rel in PORTED or _exempt(rel), (
        f"{rel} drives the JAX package: port it (PORTED) or give the "
        "reason it is not (EXEMPT)")


def test_tables_name_existing_files():
    for key in list(PORTED) + list(EXEMPT):
        assert (ROOT / key).exists(), key
    assert not set(PORTED) & set(EXEMPT)


@pytest.mark.parametrize("rel", sorted(PORTED.values()))
def test_counterpart_imports_no_jax(rel):
    path = ROOT / rel
    text = path.read_text()
    assert not NAMES_JAX.search(text), f"{rel} names the JAX package"
    if path.suffix == ".sh":
        assert not re.search(r"\bjax\b", text), rel
        assert "toybox_tpu_torch" in text or "bench_torch.py" in text, rel
        return
    for node in ast.walk(ast.parse(text, filename=rel)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{rel} imports {name}"
