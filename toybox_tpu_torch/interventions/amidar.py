"""Amidar interventions — typed state mirror + board/AI ops.

API parity with reference toybox/interventions/amidar.py: Amidar/Enemy/
Player/Board/Tile/TilePoint/WorldPoint/Box/MovementAI mirrors plus the
ops: random tile/track sampling, mode get/set (jump/chase/regular),
set_enemy_protocol with per-protocol arg validation (amidar.py:421-481),
tile<->world conversion via engine queries (amidar.py:508-518), adjacency,
enemy distances, set_player_random_start, and the feature oracles
player_tile / player_enemy_distances / player_on_painted /
player_near_unpainted (amidar.py:583-614).

A copy of toybox_tpu.interventions.amidar (pure Python) over the port's
engines, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import random
from typing import Optional

from toybox_tpu_torch.games import amidar as _engine
from toybox_tpu_torch.interventions.base import (BaseMixin, Collection,
                                                 Intervention,
                                                 InterventionNoneError,
                                                 MutationError, StandardEq)
from toybox_tpu_torch.interventions.core import Direction, Game


class TilePoint(BaseMixin):

    expected_keys = ["tx", "ty"]
    eq_keys = expected_keys
    coersions = {"tx": int, "ty": int}

    def __init__(self, intervention, tx, ty):
        super().__init__(intervention)
        self.tx = tx
        self.ty = ty
        self._in_init = False

    def __str__(self):
        return "({}, {})".format(self.tx, self.ty)

    @staticmethod
    def manhattan(tp1: "TilePoint", tp2: "TilePoint"):
        return abs(tp1.tx - tp2.tx) + abs(tp1.ty - tp2.ty)


class WorldPoint(BaseMixin):

    expected_keys = ["x", "y"]
    eq_keys = expected_keys

    def __init__(self, intervention, x, y):
        super().__init__(intervention)
        self.x = x
        self.y = y
        self._in_init = False

    def __str__(self):
        return "({}, {})".format(self.x, self.y)


class Tile(BaseMixin):

    Empty = "Empty"
    Unpainted = "Unpainted"
    Painted = "Painted"
    ChaseMarker = "ChaseMarker"
    tags = [Empty, Unpainted, Painted, ChaseMarker]

    expected_keys = []
    eq_keys = ["tag"]

    def __init__(self, intervention, name):
        super().__init__(intervention)
        assert name in Tile.tags, "%s not a valid tile tag" % name
        self.tag = name
        self._in_init = False

    def decode(intervention, rustname, clz):
        # engine-side tiles serialize as bare tag strings, or as a
        # TilePoint dict when used as an adjacency probe
        if isinstance(rustname, dict):
            tx, ty = rustname["tx"], rustname["ty"]
            tiles = intervention.game.board.tiles
            if 0 <= ty < len(tiles) and 0 <= tx < len(tiles[0]):
                return tiles[ty][tx]
            return Tile(intervention, Tile.Empty)
        assert isinstance(rustname, str)
        return Tile(intervention, rustname)

    def encode(self):
        return self.tag


class MovementAI(BaseMixin):

    expected_keys = []
    eq_keys = ["protocol", "next", "default_route_index", "start", "vert",
               "horiz", "start_vert", "start_horiz", "start_dir", "dir",
               "vision_distance", "player_seen"]

    EnemyLookupAI = "EnemyLookupAI"
    EnemyPerimeterAI = "EnemyPerimeterAI"
    EnemyAmidarMvmt = "EnemyAmidarMvmt"
    EnemyTargetPlayer = "EnemyTargetPlayer"
    EnemyRandomMvmt = "EnemyRandomMvmt"

    mvmt_protocols = [EnemyLookupAI, EnemyPerimeterAI, EnemyAmidarMvmt,
                      EnemyTargetPlayer, EnemyRandomMvmt]

    def __init__(self, intervention, protocol,
                 next: Optional[int] = None,
                 default_route_index: Optional[int] = None,
                 start=None, vert=None, horiz=None, start_vert=None,
                 start_horiz=None, start_dir=None, dir=None,
                 vision_distance: Optional[int] = None,
                 player_seen=None, **kwargs):
        super().__init__(intervention)
        assert protocol in MovementAI.mvmt_protocols, (
            "%s not a recognized movement protocol" % protocol)
        self.protocol = protocol
        self.next = next
        self.default_route_index = default_route_index
        self.start = (TilePoint.decode(intervention, start, TilePoint)
                      if isinstance(start, dict) else start)
        self.vert = vert
        self.horiz = horiz
        self.start_vert = start_vert
        self.start_horiz = start_horiz
        self.start_dir = start_dir
        self.dir = dir
        self.vision_distance = vision_distance
        self.player_seen = (TilePoint.decode(intervention, player_seen,
                                             TilePoint)
                            if isinstance(player_seen, dict) else player_seen)
        self._in_init = False

    def __repr__(self):
        return "MovementAI(protocol: {}, next: {}, route_index: {})".format(
            self.protocol, self.next, self.default_route_index)

    def decode(intervention, ai, clz):
        ai_name = list(ai.keys())[0]
        return MovementAI(intervention, ai_name, **ai[ai_name])

    def encode(self):
        args = {}
        for k, v in self.__dict__.items():
            if (k in self.immutable_fields or v is None
                    or k in ("protocol", "_in_init", "schema")):
                continue
            args[k] = v.encode() if isinstance(v, BaseMixin) else v
        return {self.protocol: args}


class Enemy(BaseMixin):

    expected_keys = ["history", "step", "position", "caught", "speed", "ai"]
    immutable_fields = BaseMixin.immutable_fields + ["ai"]
    eq_keys = expected_keys

    def __init__(self, intervention, history, step, position, caught, speed,
                 ai):
        super().__init__(intervention)
        self.history = history
        self.step = step
        self.position = WorldPoint.decode(intervention, position, WorldPoint)
        self.caught = caught
        self.speed = speed
        self.ai = MovementAI.decode(intervention, ai, MovementAI)
        self._in_init = False

    def __repr__(self):
        return "Enemy({})".format(" ".join(
            str(getattr(self, k)) for k in Enemy.expected_keys))


class EnemyCollection(Collection):

    expected_keys = []

    def __init__(self, intervention, enemies):
        super().__init__(intervention, enemies, Enemy)
        self._in_init = False

    def decode(intervention, enemies, clz):
        return EnemyCollection(intervention, enemies)


class Player(BaseMixin):

    expected_keys = ["history", "step", "position", "caught", "speed", "ai"]
    eq_keys = expected_keys

    def __init__(self, intervention, history, step, position, caught, speed,
                 ai):
        super().__init__(intervention)
        self.history = history
        self.step = step
        self.position = WorldPoint.decode(intervention, position, WorldPoint)
        self.caught = caught
        self.speed = speed
        self.ai = ai
        self._in_init = False


class Box(BaseMixin):

    expected_keys = ["triggers_chase", "top_left", "bottom_right", "painted"]
    eq_keys = expected_keys

    def __init__(self, intervention, triggers_chase, top_left, bottom_right,
                 painted):
        super().__init__(intervention)
        self.triggers_chase = triggers_chase
        self.top_left = TilePoint.decode(intervention, top_left, TilePoint)
        self.bottom_right = TilePoint.decode(intervention, bottom_right,
                                             TilePoint)
        self.painted = painted
        self._in_init = False


class BoxCollection(Collection):

    expected_keys = []

    def __init__(self, intervention, boxes):
        super().__init__(intervention, boxes, Box)
        self._in_init = False

    def decode(intervention, boxes, clz):
        return BoxCollection(intervention, boxes)


class Board(BaseMixin):

    expected_keys = ["width", "height", "tiles", "boxes", "junctions",
                     "chase_junctions"]
    eq_keys = ["tiles", "boxes"]

    def __init__(self, intervention, width, height, tiles, boxes, junctions,
                 chase_junctions):
        super().__init__(intervention)
        self.width = width
        self.height = height
        self.tiles = [[Tile.decode(intervention, t, Tile) for t in row]
                      for row in tiles]
        self.boxes = BoxCollection.decode(intervention, boxes, BoxCollection)
        self.junctions = junctions
        self.chase_junctions = chase_junctions
        self._in_init = False

    def encode(self):
        return {
            "width": self.width,
            "height": self.height,
            "tiles": [[t.encode() for t in row] for row in self.tiles],
            "boxes": self.boxes.encode(),
            "junctions": self.junctions,
            "chase_junctions": self.chase_junctions,
        }


class Amidar(Game):

    expected_keys = _engine.schema()["required"]
    eq_keys = [k for k in expected_keys if k != "rand"]
    immutable_fields = Game.immutable_fields + ["enemies"]

    def __init__(self, intervention, score=None, player=None, lives=None,
                 rand=None, level=None, enemies=None, jumps=None,
                 jump_timer=None, chase_timer=None, board=None):
        assert intervention
        super().__init__(intervention, score, lives, rand, level)
        self.enemies = EnemyCollection.decode(intervention, enemies,
                                              EnemyCollection)
        self.jumps = jumps
        self.jump_timer = jump_timer
        self.chase_timer = chase_timer
        self.board = Board.decode(intervention, board, Board)
        self.player = Player.decode(intervention, player, Player)
        self._in_init = False


class AmidarIntervention(Intervention):

    jump = "jump"
    chase = "chase"
    regular = "regular"
    modes = [jump, chase, regular]

    def __init__(self, tb, modelmod=None, data=None, eq_mode=StandardEq):
        Intervention.__init__(self, tb, "amidar", Amidar, modelmod=modelmod,
                              data=data, eq_mode=eq_mode)

    # -- tiles -------------------------------------------------------------
    def get_tile_by_pos(self, tx, ty) -> Tile:
        return self.game.board.tiles[ty][tx]

    def filter_tiles(self, pred=lambda t: True):
        return [t for row in self.game.board.tiles for t in row if pred(t)]

    def is_tile_walkable(self, tile):
        return tile.tag != Tile.Empty

    def set_tile_tag(self, tile, tag):
        assert tag in Tile.tags, "Unrecognized tile tag: %s" % tag
        tile.tag = tag

    def get_random_tile(self, pred=lambda t: True):
        tiles = self.filter_tiles(pred)
        if not tiles:
            raise ValueError("Random selection failed.")
        return random.choice(tiles)

    def get_random_track_position(self):
        t = self.get_random_tile(pred=lambda tile: tile.tag != "Empty")
        return self.tile_to_worldpoint(t)

    # -- coordinates (engine-side queries, reference amidar.py:508-518) ----
    def tile_to_tilepoint(self, tile):
        for y, row in enumerate(self.game.board.tiles):
            for x, t in enumerate(row):
                if t is tile:
                    return TilePoint(self, tx=x, ty=y)
        raise ValueError("Tile %s not found in tiles" % tile)

    def tilepoint_to_worldpoint(self, tp):
        return WorldPoint(
            self, *self.toybox.query_state_json("tile_to_world", tp.encode()))

    def tile_to_worldpoint(self, tile):
        return self.tilepoint_to_worldpoint(self.tile_to_tilepoint(tile))

    def worldpoint_to_tilepoint(self, wp):
        return TilePoint(
            self, *self.toybox.query_state_json("world_to_tile", wp.encode()))

    def get_adjacent_tiles(self, tp: TilePoint, filter_fn=lambda t: t):
        def adj(t):
            ttp = self.tile_to_tilepoint(t)
            if abs(ttp.tx - tp.tx) + abs(ttp.ty - tp.ty) == 1:
                return filter_fn(t)
            return False
        return self.filter_tiles(pred=adj)

    # -- modes -------------------------------------------------------------
    def get_regular_mode(self):
        return self.game.jump_timer == 0 and self.game.chase_timer == 0

    def get_jump_mode(self):
        return self.game.jump_timer > 0

    def get_chase_mode(self):
        return self.game.chase_timer > 0

    def any_enemy_caught(self, eid=None):
        return any(e.caught for e in self.game.enemies)

    def set_mode(self, mode, set_time=None):
        assert mode in AmidarIntervention.modes
        if mode == AmidarIntervention.jump:
            self.game.jump_timer = set_time or self.config["jump_time"]
        elif mode == AmidarIntervention.chase:
            self.game.chase_timer = set_time or self.config["chase_time"]
        else:
            self.game.jump_timer = 0
            self.game.chase_timer = 0

    # -- enemies -----------------------------------------------------------
    def set_enemy_protocol(self, enemy, protocol, **kwargs):
        """Per-protocol arg validation matching reference amidar.py:421-481."""
        assert protocol in MovementAI.mvmt_protocols, (
            "%s not a valid protocol" % protocol)

        def assert_keys(k, t, option=False):
            assert k in kwargs, (
                "Missing argument %s for protocol %s" % (k, protocol))
            v = kwargs[k]
            if option and v is None:
                return
            assert type(v) == t, (
                "Expecting %s to have type %s; is %s" % (k, t, type(v)))

        if protocol == MovementAI.EnemyLookupAI:
            assert_keys("next", int)
            assert_keys("default_route_index", int)
        elif protocol == MovementAI.EnemyPerimeterAI:
            assert_keys("start", TilePoint)
        elif protocol == MovementAI.EnemyAmidarMvmt:
            assert_keys("vert", Direction)
            assert_keys("horiz", Direction)
            assert_keys("start_vert", Direction)
            assert_keys("start_horiz", Direction)
            assert_keys("start", TilePoint)
        elif protocol == MovementAI.EnemyTargetPlayer:
            assert_keys("start", TilePoint)
            assert_keys("start_dir", Direction)
            assert_keys("vision_distance", int)
            assert_keys("dir", Direction)
            assert_keys("player_seen", TilePoint, option=True)
        elif protocol == MovementAI.EnemyRandomMvmt:
            assert_keys("start", TilePoint)
            assert_keys("start_dir", Direction)
            assert_keys("dir", Direction)
        enemy.ai.protocol = protocol
        for k, v in kwargs.items():
            setattr(enemy.ai, k, v)

    def enemy_distances_from_tile(self, t, dist_fn=TilePoint.manhattan):
        tp = self.tile_to_tilepoint(t)
        etps = [self.worldpoint_to_tilepoint(e.position)
                for e in self.game.enemies]
        return [dist_fn(etp, tp) for etp in etps]

    def set_player_random_start(self, min_enemy_distance=5):
        def far_enough(t):
            dists = self.enemy_distances_from_tile(t)
            return (not any(d < min_enemy_distance for d in dists)
                    and self.is_tile_walkable(t))
        pos = self.get_random_tile(pred=far_enough)
        self.game.player.position = self.tile_to_worldpoint(pos)

    def get_random_dir_for_tile(self, tile):
        assert tile.tag != "Empty"
        tp = self.tile_to_tilepoint(tile)
        dirs = list(Direction.directions)
        random.shuffle(dirs)
        for d in dirs:
            dx, dy = {"Up": (0, -1), "Down": (0, 1),
                      "Left": (-1, 0), "Right": (1, 0)}[d]
            ntx, nty = tp.tx + dx, tp.ty + dy
            tiles = self.game.board.tiles
            if 0 <= nty < len(tiles) and 0 <= ntx < len(tiles[0]):
                if self.is_tile_walkable(tiles[nty][ntx]):
                    return d
        raise Exception("No valid direction from this tile: Tile tx:%s, ty%s"
                        % (tile.tx, tile.ty))

    # -- feature oracles (reference amidar.py:583-614) ---------------------
    def player_tile(self):
        ptp = self.worldpoint_to_tilepoint(self.game.player.position)
        return self.get_tile_by_pos(ptp.tx, ptp.ty)

    def player_enemy_distances(self, distmeas=TilePoint.manhattan):
        return self.enemy_distances_from_tile(self.player_tile(), distmeas)

    def player_on_painted(self):
        return self.player_tile().tag == Tile.Painted

    def player_near_unpainted(self, radius=5):
        ptp = self.worldpoint_to_tilepoint(self.game.player.position)

        def in_radius(t):
            tp = self.tile_to_tilepoint(t)
            return TilePoint.manhattan(ptp, tp) < radius

        near = [t for t in self.filter_tiles(pred=in_radius)
                if self.is_tile_walkable(t)]
        painted = sum(t.tag == Tile.Painted for t in near)
        return painted != len(near)
