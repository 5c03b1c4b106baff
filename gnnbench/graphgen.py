"""Graphs made from the seed: the benchmark's frozen copy of the generators.

``random_graph`` is a copy of the port's ``gnn.graphs.random_graph``
(power-law and uniform samplers), returning plain arrays; a later change
to the program's generator cannot move the benchmark's graphs.
``PAPER_DATASETS`` holds the rows of the paper's Table 3 the cells use.

``undirected_csr`` and ``sample_neighbourhoods`` draw the served
requests: the 2-hop neighbourhoods that a GraphSAGE neighbour sampler
(Hamilton et al., NeurIPS 2017; fan-outs 25 and 10) takes around a few
seed vertices of such a graph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

#: paper Table 3: name -> (vertices, edges, degree model)
PAPER_DATASETS = {
    "ak2010": (45_293, 108_549, "uniform"),
    "coAuthorsDBLP": (299_068, 977_676, "powerlaw"),
    "cit-Patents": (3_774_768, 16_518_948, "powerlaw"),
}

POWERLAW_EXPONENT = 0.9


@dataclasses.dataclass
class Arrays:
    """A directed graph in COO: edge e runs src[e] -> dst[e]."""

    src: np.ndarray          # int32 (E,)
    dst: np.ndarray          # int32 (E,)
    n_vertices: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def random_graph(n_vertices: int, n_edges: int, seed: int,
                 model: str = "powerlaw") -> Arrays:
    """Copy of the port's ``random_graph`` (no edge types)."""
    rng = np.random.default_rng(seed)
    if model == "powerlaw":
        ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
        probs = ranks ** -POWERLAW_EXPONENT
        probs /= probs.sum()
        src = rng.choice(n_vertices, size=n_edges, p=probs).astype(np.int32)
        dst = rng.choice(n_vertices, size=n_edges, p=probs).astype(np.int32)
        perm = rng.permutation(n_vertices).astype(np.int32)
        src, dst = perm[src], perm[dst]
    elif model == "uniform":
        src = rng.integers(0, n_vertices, size=n_edges, dtype=np.int32)
        dst = rng.integers(0, n_vertices, size=n_edges, dtype=np.int32)
    else:
        raise ValueError(model)
    return Arrays(src=src, dst=dst, n_vertices=n_vertices)


def paper_graph(dataset: str, seed: int) -> Arrays:
    """The synthetic stand-in of a Table 3 dataset at its full size."""
    v, e, model = PAPER_DATASETS[dataset]
    return random_graph(v, e, seed, model)


def undirected_csr(g: Arrays, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each vertex's neighbours over both directions of ``g``'s edges, as
    ``(indptr, neighbours)`` on ``device``: a co-authorship is symmetric.
    Self-loops and repeated pairs are dropped, so a neighbour appears once."""
    V = g.n_vertices
    s = torch.as_tensor(g.src, device=device).long()
    d = torch.as_tensor(g.dst, device=device).long()
    keep = s != d
    pairs = torch.unique(torch.minimum(s, d)[keep] * V + torch.maximum(s, d)[keep])
    lo, hi = pairs // V, pairs % V
    at, nbr = torch.cat([lo, hi]), torch.cat([hi, lo])
    order = torch.argsort(at * V + nbr)
    indptr = torch.zeros(V + 1, dtype=torch.long, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(at, minlength=V), 0)
    return indptr, nbr[order]


def pick_neighbours(indptr: torch.Tensor, nbrs: torch.Tensor,
                    targets: torch.Tensor, k: int, gen: torch.Generator):
    """Up to ``k`` distinct neighbours of each target, uniformly without
    replacement (all of them where it has ``k`` or fewer): ``(row, nbr)``,
    the target's row in ``targets`` and the neighbour, one pair an edge.
    Floyd's algorithm, one step a column over every target at once."""
    dev, n = targets.device, targets.shape[0]
    start = indptr[targets]
    deg = indptr[targets + 1] - start
    slot = torch.arange(k, device=dev).repeat(n, 1)
    big = torch.nonzero(deg > k)[:, 0]
    if len(big):
        d, m = deg[big], len(big)
        chosen = torch.empty((m, k), dtype=torch.long, device=dev)
        for i in range(k):
            j = d - k + i
            u = torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
            x = torch.minimum((u * (j + 1)).long(), j)
            taken = (chosen[:, :i] == x[:, None]).any(1)
            chosen[:, i] = torch.where(taken, j, x)
        slot[big] = chosen
    valid = slot < deg[:, None]
    row = torch.arange(n, device=dev)[:, None].expand(n, k)[valid]
    return row, nbrs[(start[:, None] + slot)[valid]]


def _first_seen(keys: torch.Tensor) -> torch.Tensor:
    """The distinct values of ``keys`` in the order they first appear."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((len(uniq),), len(keys), dtype=torch.long,
                       device=keys.device).scatter_reduce_(
        0, inv, torch.arange(len(keys), device=keys.device), "amin")
    return uniq[torch.argsort(first)]


def sample_neighbourhoods(indptr: torch.Tensor, nbrs: torch.Tensor,
                          seeds_per_request: Sequence[int],
                          fanouts: Sequence[int],
                          gen: torch.Generator) -> List[Arrays]:
    """One GraphSAGE-style sampled neighbourhood a request, as a
    mini-batch of a neighbour sampler holds it.

    Request ``r`` names ``seeds_per_request[r]`` seed vertices, drawn
    uniformly from the vertices with a neighbour (a repeat is dropped).
    Hop ``h`` samples up to ``fanouts[h]`` neighbours of each vertex the
    previous hop added (the seeds, at hop 0) and adds an edge from each
    sampled neighbour to its vertex; a neighbour the request already holds
    adds the edge and no vertex.  A request's vertices are numbered seeds
    first, then each hop's new vertices in the order they were sampled.
    All requests are drawn together, in a few large calls on the device.
    """
    dev = nbrs.device
    V = indptr.shape[0] - 1
    k = torch.as_tensor(np.asarray(seeds_per_request, np.int64), device=dev)
    R = len(k)
    has = torch.nonzero(indptr[1:] > indptr[:-1])[:, 0]
    req = torch.repeat_interleave(torch.arange(R, device=dev), k)
    seeds = has[torch.randint(0, len(has), (len(req),), generator=gen, device=dev)]
    frontier = _first_seen(req * V + seeds)      # key: request * V + vertex
    held, srcs, dsts = [frontier], [], []
    for fanout in fanouts:
        row, nbr = pick_neighbours(indptr, nbrs, frontier % V, fanout, gen)
        key = (frontier[row] // V) * V + nbr
        srcs.append(key)
        dsts.append(frontier[row])
        new = _first_seen(key)
        frontier = new[~torch.isin(new, torch.cat(held))]
        held.append(frontier)
    # number each request's vertices in the order they were added
    nodes = torch.cat(held)
    nodes = nodes[torch.sort(nodes // V, stable=True).indices]
    n_v = torch.bincount(nodes // V, minlength=R)
    v_off = torch.cumsum(n_v, 0) - n_v
    local = torch.arange(len(nodes), device=dev) - v_off[nodes // V]
    by_key = torch.argsort(nodes)
    sorted_keys = nodes[by_key]

    def number(keys):
        return local[by_key[torch.searchsorted(sorted_keys, keys)]]

    src, dst = torch.cat(srcs), torch.cat(dsts)
    order = torch.sort(dst // V, stable=True).indices
    src, dst = src[order], dst[order]
    n_e = torch.bincount(dst // V, minlength=R).cpu().numpy()
    src = number(src).to(torch.int32).cpu().numpy()
    dst = number(dst).to(torch.int32).cpu().numpy()
    e_off = np.concatenate([[0], np.cumsum(n_e)])
    return [Arrays(src=src[e_off[r]:e_off[r + 1]], dst=dst[e_off[r]:e_off[r + 1]],
                   n_vertices=int(v))
            for r, v in enumerate(n_v.cpu().numpy())]
