"""Interactive human play (port of toybox_tpu.human_play; reference
`python -m ctoybox.human_play <game>`, README.md:55-60, and
scripts/utils/human_play_ale.py: keyboard -> ALE 18-action encoding
:14-50, action-trace recording).

    python -m toybox_tpu_torch.human_play breakout [--scale 3] \
        [--record out.json] [--device cuda]

Arrows move, space fires, q/ESC quits. pygame is imported inside
``main``, so the module imports without it.
"""

from __future__ import annotations

import argparse
import json


def keys_to_ale(up, down, left, right, fire) -> int:
    """Keyboard state -> ALE action index (the 18-action encoder from
    reference human_play_ale.py:14-50)."""
    name = ""
    if up:
        name += "UP"
    elif down:
        name += "DOWN"
    if left:
        name += "LEFT"
    elif right:
        name += "RIGHT"
    if fire:
        name += "FIRE"
    if not name:
        name = "NOOP"
    from toybox_tpu_torch.core.actions import ACTION_LOOKUP
    return ACTION_LOOKUP.get(name, 0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("game")
    parser.add_argument("--scale", type=int, default=3)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--record", type=str, default=None,
                        help="write the action trace to this JSON file")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import pygame

    from toybox_tpu_torch import Toybox

    tb = Toybox(args.game, grayscale=False, seed=args.seed,
                device=args.device)
    w, h = tb.get_width(), tb.get_height()
    pygame.init()
    screen = pygame.display.set_mode((w * args.scale, h * args.scale))
    pygame.display.set_caption(f"toybox_tpu_torch — {args.game}")
    clock = pygame.time.Clock()

    trace = []
    running = True
    while running:
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                running = False
        keys = pygame.key.get_pressed()
        if keys[pygame.K_q] or keys[pygame.K_ESCAPE]:
            running = False
        action = keys_to_ale(keys[pygame.K_UP], keys[pygame.K_DOWN],
                             keys[pygame.K_LEFT], keys[pygame.K_RIGHT],
                             keys[pygame.K_SPACE])
        tb.apply_ale_action(action)
        trace.append(action)
        if tb.game_over():
            print(f"game over — score {tb.get_score()}")
            tb.new_game()

        frame = tb.get_rgb_frame()
        surf = pygame.surfarray.make_surface(np.swapaxes(frame, 0, 1))
        surf = pygame.transform.scale(surf, (w * args.scale, h * args.scale))
        screen.blit(surf, (0, 0))
        pygame.display.flip()
        clock.tick(args.fps)

    pygame.quit()
    if args.record:
        with open(args.record, "w") as f:
            json.dump({"game": args.game, "seed": args.seed,
                       "actions": trace}, f)
        print(f"wrote {len(trace)} actions to {args.record}")
    print(f"final score: {tb.get_score()}")


if __name__ == "__main__":
    main()
