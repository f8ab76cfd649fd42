"""The port's regress gate on the CPU at a small size, and the rule that the
port imports nothing of JAX."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from toybox_tpu_torch import regress
from toybox_tpu_torch.rl.checkpoint import load_state_dict


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these ops are small, and the test workers
    share the cores (as tests/test_torch_codecs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "msgpack", "toybox_tpu")


def test_play_games_on_cpu_gives_finite_scores():
    seen = []
    scores = regress.play_games(
        "breakout", load_state_dict(ROOT / "models/Breakout.regress.model"),
        "cnn", 2, device="cpu", chunk=16, max_frames=4 * 16 * 3,
        on_chunk=lambda steps, totals: seen.append(steps))
    assert scores.shape == (2,) and np.isfinite(scores).all()
    assert (scores >= 0).all()
    assert seen == [16, 32, 48]


@pytest.mark.parametrize("model,game", [
    ("SpaceInvaders.regress.model", "space_invaders"),
    ("Amidar.regress.model", "amidar")])
def test_play_games_other_games_on_cpu(model, game):
    scores = regress.play_games(
        game, load_state_dict(ROOT / "models" / model), "cnn", 2,
        device="cpu", chunk=16, max_frames=4 * 16 * 2)
    assert scores.shape == (2,) and np.isfinite(scores).all()
    assert (scores >= 0).all()


def test_env_id_to_game():
    assert regress.env_id_to_game("BreakoutToyboxNoFrameskip-v4") == \
        "breakout"
    assert regress.env_id_to_game("SpaceInvadersToyboxNoFrameskip-v4") == \
        "space_invaders"
    assert regress.env_id_to_game("AmidarToyboxNoFrameskip-v4") == "amidar"
    with pytest.raises(ValueError):
        regress.env_id_to_game("PongNoFrameskip-v4")


def _port_files():
    files = sorted((ROOT / "toybox_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "scripts" / "port_op_counts.py",
                    ROOT / "scripts" / "frame_kernel_variants.py",
                    ROOT / "scripts" / "port_gates.py",
                    ROOT / "scripts" / "train_recipe.py",
                    ROOT / "scripts" / "train_path_vs_cpu.py",
                    ROOT / "bench_torch.py",
                    ROOT / "scripts" / "port_ppo_step_timing.py",
                    ROOT / "scripts" / "port_behavior_matrix.py",
                    ROOT / "scripts" / "port_start_images.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {name}"
