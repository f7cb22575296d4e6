"""The shard map of multi-rank training (port of xgboost_tpu/elastic.py's
``ShardMap``): which rank owns which of ``num_shards`` data shards.

``ExtMemConfig`` (data/extmem.py) hands each rank its map, and the rank's
``data_fn`` yields the pages of the shards it owns.  The map is a pure
function of ``(num_shards, world)``: shard ``s`` belongs to rank
``s % world``.  Elastic membership (``ElasticConfig``, ``RegroupRequired``:
survivors regrouping at a smaller world, replacements absorbed at round
boundaries) is not ported (ROADMAP Queue 1 item 9b.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

__all__ = ["ShardMap"]


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """``num_shards`` data shards assigned to ``world`` ranks (reference
    elastic.py:60): ``assign[s]`` is the rank owning shard ``s``,
    round robin.  A rank owns the union of its shards."""

    num_shards: int
    world: int
    assign: Tuple[int, ...]

    @classmethod
    def create(cls, num_shards: int, world: int) -> "ShardMap":
        num_shards = int(num_shards)
        world = int(world)
        if num_shards < 1 or world < 1:
            raise ValueError(
                f"ShardMap needs num_shards >= 1 and world >= 1; got "
                f"{num_shards}, {world}")
        if num_shards < world:
            raise ValueError(
                f"num_shards ({num_shards}) must be >= world ({world}): "
                "a rank with no data cannot contribute to the quantile "
                "sketch or the histogram exchange")
        return cls(num_shards=num_shards, world=world,
                   assign=tuple(s % world for s in range(num_shards)))

    def shards_of(self, rank: int) -> Tuple[int, ...]:
        """The shards ``rank`` owns, in ascending order."""
        return tuple(s for s, r in enumerate(self.assign) if r == int(rank))

    def rebalance(self, world: int) -> "ShardMap":
        """The map of the same shards at another world size."""
        return ShardMap.create(self.num_shards, world)

    def to_dict(self) -> Dict[str, Any]:
        return {"num_shards": self.num_shards, "world": self.world,
                "assign": list(self.assign)}

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ShardMap":
        num_shards = int(obj["num_shards"])
        world = int(obj["world"])
        assign = obj.get("assign")
        if assign is None:
            return cls.create(num_shards, world)
        assign = tuple(int(r) for r in assign)
        if len(assign) != num_shards:
            raise ValueError(
                f"shard map assign length {len(assign)} != num_shards "
                f"{num_shards}")
        return cls(num_shards=num_shards, world=world, assign=assign)
