#!/bin/bash
# Test entry of the PyTorch + CUDA port (reference
# scripts/utils/unit_tests.sh): the facade smoke on the CPU, then the
# port's test files (which hold the port against the reference package,
# so they run where both are installed).
set -e
cd "$(dirname "$0")/.."
python3 - <<'PY'
# FFI-style smoke test (reference scripts/utils/test_games.py:42-78)
from toybox_tpu_torch import Toybox
for game in ("breakout", "amidar", "space_invaders", "gridworld"):
    with Toybox(game, device="cpu") as tb:
        cfg = tb.config_to_json(); tb.write_config_json(cfg)
        st = tb.to_state_json(); tb.write_state_json(st)
        assert tb.to_state_json() == st, game
        assert tb.get_legal_action_set()
        tb.set_seed(1234); tb.new_game()
        for _ in range(100):
            tb.apply_ale_action(0)
        assert tb.get_rgb_frame().shape[2] == 3
        print(f"{game}: OK")
PY
python3 -m pytest tests/test_torch_*.py -q
