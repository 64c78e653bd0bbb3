"""Corpus: sharding axes outside their vocabularies."""
from repro_torch.dist import fsdp
from repro_torch.dist.sharding import NamedSharding, placements, pspec


def specs(mesh, x, rules):
    a = placements(("data", "modle"), mesh)           # flagged: typo'd mesh axis
    b = NamedSharding(mesh, (("pod", "replica"), None))  # flagged: unknown mesh axis
    c = pspec(("embed", "hedas"), (8, 8), rules, mesh)  # flagged: typo'd logical axis
    d = fsdp.constrain(x, ("act_batch", None, "act_embed"))  # known logical axes: clean
    return a, b, c, d
