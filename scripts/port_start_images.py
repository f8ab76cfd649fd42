#!/usr/bin/env python
"""Dump start frames of the PyTorch + CUDA port for visual fidelity
checks, the counterpart of scripts/start_images.py (reference
scripts/utils/start_images{,_toybox}).

    python3 scripts/port_start_images.py [--out start_images_torch] \
        [--grid N] [--device cuda|cpu]

Writes <game>_start.png for each game, played through the port's
``Toybox`` facade past its intro pause, and with ``--grid N`` a tile of N
batched-env (``BatchedEnv``, obs_mode "rgb") Breakout starts. Runs on
``cuda`` unless given ``--device cpu``; with no card it raises.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GAMES = ("breakout", "amidar", "space_invaders", "gridworld")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="start_images_torch")
    parser.add_argument("--grid", type=int, default=0,
                        help="also tile N batched-env start frames")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from PIL import Image

    from toybox_tpu_torch import Toybox
    from toybox_tpu_torch.benchmark import require_device

    dev = require_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    for game in GAMES:
        with Toybox(game, grayscale=False, device=dev) as tb:
            # advance past intro pauses so the scene is populated
            for _ in range(140):
                tb.apply_ale_action(0)
            path = os.path.join(args.out, f"{game}_start.png")
            Image.fromarray(tb.get_rgb_frame()).save(path)
            print("wrote", path)

    if args.grid:
        from toybox_tpu_torch.envs.batched import BatchedEnv
        from toybox_tpu_torch.utils.misc import tile_images

        env = BatchedEnv("breakout", args.grid, obs_mode="rgb", device=dev)
        obs = env.reset(seed=0).cpu().numpy()
        path = os.path.join(args.out, "breakout_grid.png")
        Image.fromarray(tile_images(obs)).save(path)
        print("wrote", path)


if __name__ == "__main__":
    main()
