"""Breakout interventions — typed state mirror + board ops.

API parity with reference toybox/interventions/breakout.py: the
Breakout/Paddle/Brick/Ball(+Collections) mirrors, and the ops
num_bricks_remaining, add_row, is_stack, is_channel, get_column/row,
channel_count, add_channel, fill_column, find_channel, find_brick,
clear_board, get_ball/paddle_position/velocity. Paddle velocity coersion
pins y=0 (reference breakout.py:133-136).

A copy of toybox_tpu.interventions.breakout (pure Python) over the port's
engines, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from toybox_tpu_torch.games import breakout as _engine
from toybox_tpu_torch.interventions.base import (BaseMixin, Collection,
                                                 Intervention, StandardEq)
from toybox_tpu_torch.interventions.core import Color, Game, Vec2D


class Paddle(BaseMixin):
    # reference breakout.py:131-147

    expected_keys = ["velocity", "position"]
    eq_keys = expected_keys

    def __init__(self, intervention, velocity, position):
        super().__init__(intervention)
        self.velocity = Vec2D.decode(intervention, velocity, Vec2D)
        self.position = Vec2D.decode(intervention, position, Vec2D)
        self._in_init = False

    def __setattr__(self, name, value):
        # wandering-paddle guard: any velocity write pins y to 0
        if name == "velocity" and isinstance(value, Vec2D):
            value = Vec2D.decode(value.intervention,
                                 {"x": value.x, "y": 0.0}, Vec2D)
        super().__setattr__(name, value)

    def __str__(self):
        return "<position: {}, velocity: {}>".format(self.position,
                                                     self.velocity)


class Brick(BaseMixin):

    expected_keys = ["destructible", "depth", "color", "alive", "points",
                     "size", "position", "row", "col"]
    eq_keys = expected_keys
    coersions = {
        "alive": lambda x: x > 0.5,
        "destructible": lambda x: x > 0.5,
        "depth": lambda x: max(0, int(x)),
        "points": lambda x: max(0, int(x)),
        "row": lambda x: max(0, int(x)),
        "col": lambda x: max(0, int(x)),
    }

    def __init__(self, intervention, destructible, depth, color, alive,
                 points, size, position, row, col):
        super().__init__(intervention)
        self.destructible = destructible
        self.depth = depth
        self.color = Color.decode(intervention, color, Color)
        self.alive = alive
        self.points = points
        self.size = Vec2D.decode(intervention, size, Vec2D)
        self.position = Vec2D.decode(intervention, position, Vec2D)
        self.row = row
        self.col = col
        self._in_init = False

    def __repr__(self):
        return "Brick({})".format(" ".join(
            str(getattr(self, k)) for k in Brick.expected_keys))


class BrickCollection(Collection):

    def __init__(self, intervention, bricks):
        super().__init__(intervention, bricks, Brick)
        self._in_init = False

    def decode(intervention, bricks, clz):
        return BrickCollection(intervention, bricks)


class Ball(BaseMixin):

    expected_keys = ["position", "velocity"]
    eq_keys = expected_keys

    def __init__(self, intervention, position, velocity):
        super().__init__(intervention)
        self.position = Vec2D.decode(intervention, position, Vec2D)
        self.velocity = Vec2D.decode(intervention, velocity, Vec2D)
        self._in_init = False

    def __str__(self):
        return "Ball(position: {}, velocity: {})".format(self.position,
                                                         self.velocity)


class BallCollection(Collection):

    def __init__(self, intervention, balls):
        super().__init__(intervention, balls, Ball)
        self._in_init = False

    def decode(intervention, balls, clz):
        return BallCollection(intervention, balls)


class Breakout(Game):

    expected_keys = _engine.schema()["required"]
    eq_keys = [k for k in expected_keys if k != "rand"]
    immutable_fields = Game.immutable_fields + ["balls", "bricks", "reset"]
    coersions = {
        **Game.coersions,
        "is_dead": lambda x: x > 0.5,
        "reset": lambda x: False if x is None else x > 0.5,
    }

    def __init__(self, intervention, score=None, lives=None, rand=None,
                 level=None, paddle=None, paddle_width=None,
                 paddle_speed=None, ball_radius=None, balls=None,
                 bricks=None, reset=None, is_dead=None):
        super().__init__(intervention, score, lives, rand, level)
        self.reset = Breakout.coersions["reset"](reset)
        self.paddle = Paddle.decode(intervention, paddle, Paddle)
        self.ball_radius = ball_radius
        self.bricks = BrickCollection.decode(intervention, bricks,
                                             BrickCollection)
        self.balls = BallCollection.decode(intervention, balls,
                                           BallCollection)
        self.paddle_speed = paddle_speed
        self.paddle_width = paddle_width
        self.is_dead = Breakout.coersions["is_dead"](is_dead)
        self._in_init = False


class BreakoutIntervention(Intervention):

    def __init__(self, tb, modelmod=None, data=None, eq_mode=StandardEq):
        Intervention.__init__(self, tb, "breakout", Breakout,
                              modelmod=modelmod, data=data, eq_mode=eq_mode)

    # -- board predicates/queries (reference breakout.py:303-429) ---------
    def num_bricks_remaining(self):
        return sum(int(b.alive) for b in self.game.bricks)

    def num_bricks(self):
        return len(self.game.bricks)

    def num_rows(self):
        return len(self.config["row_scores"])

    def num_columns(self):
        return self.num_bricks() // self.num_rows()

    def is_stack(self, bricks):
        col = bricks[0].col
        return all(b.col == col for b in bricks)

    def is_channel(self, bricklist):
        col = bricklist[0].col
        return all(b.col == col and not b.alive for b in bricklist)

    def get_column(self, i):
        return [b for b in self.game.bricks if b.col == i]

    def get_row(self, i):
        return [b for b in self.game.bricks if b.row == i]

    def channel_count(self):
        return sum(1 for i in range(self.num_columns())
                   if self.is_channel(self.get_column(i)))

    def find_channel(self):
        for i in range(self.num_columns()):
            col = self.get_column(i)
            if self.is_channel(col):
                return i, col
        return -1, None

    def find_brick(self, pred):
        for i, b in enumerate(self.game.bricks):
            if pred(b):
                return i, b
        raise ValueError("No bricks that satisfy the input predicate found.")

    # -- board edits ------------------------------------------------------
    def add_row(self, bricks, points, pre=None, post=None):
        if len(bricks) != self.num_bricks():
            raise ValueError(
                "Input brick list length incorrect (is %d; should be %d)"
                % (len(bricks), self.num_bricks()))
        if pre:
            for brick in reversed(bricks):
                self.game.bricks.insert(0, brick)
        elif post:
            self.game.bricks.extend(bricks)
        else:
            raise ValueError(
                "Must provide one optional argument: pre or post.")
        self.config["row_scores"].append(points)
        self.dirty_config = True

    def add_channel(self, i):
        for brick in self.game.bricks:
            if brick.col == i and brick.alive:
                brick.alive = False

    def fill_column(self, i):
        for brick in self.game.bricks:
            if brick.col == i and not brick.alive:
                brick.alive = True

    def clear_board(self):
        for brick in self.game.bricks:
            brick.alive = False

    # -- kinematics accessors ---------------------------------------------
    def get_ball_position(self):
        balls = self.game.balls
        return ([b.position for b in balls] if len(balls) > 1
                else balls[0].position)

    def get_ball_velocity(self):
        balls = self.game.balls
        return ([b.velocity for b in balls] if len(balls) > 1
                else balls[0].velocity)

    def get_paddle_position(self):
        return self.game.paddle.position

    def get_paddle_velocity(self):
        return self.game.paddle.velocity
