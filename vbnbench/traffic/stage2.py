"""The upstream Stage II posterior-query generators, frozen and JAX-free.

Copies of ``benchmarking/query_gen.py`` (the query ``:33-49``, kept to its target and evidence;
ancestors / descendants / Markov blanket ``:52-84``, the moralized-graph
analytics ``:87-128``, the PAC-diverse target choice ``:131-219``, the
discrete generator ``:222-264``) and of
``benchmarking/gaussian_bn.py:169-235`` (the Gaussian generator). The
graph analytics ran on networkx there; here they are plain Python over
the moralized graph (exact Brandes betweenness, Tarjan articulation
points, eccentricity by breadth-first search), which is what networkx
computes on graphs of up to 200 nodes.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class InferenceQuery(NamedTuple):
    target: str
    evidence: Dict[str, float]  # node -> state index (discrete) or value


def ancestors(net, node: str) -> set:
    out = set()
    stack = list(net.parents[node])
    while stack:
        p = stack.pop()
        if p not in out:
            out.add(p)
            stack.extend(net.parents[p])
    return out


def _children(net) -> Dict[str, List[str]]:
    children: Dict[str, List[str]] = {n: [] for n in net.nodes}
    for c in net.nodes:
        for p in net.parents[c]:
            children[p].append(c)
    return children


def descendants(net, node: str) -> set:
    children = _children(net)
    out = set()
    stack = list(children[node])
    while stack:
        c = stack.pop()
        if c not in out:
            out.add(c)
            stack.extend(children[c])
    return out


def markov_blanket(net, node: str) -> set:
    children = [c for c in net.nodes if node in net.parents[c]]
    mb = set(net.parents[node]) | set(children)
    for c in children:
        mb |= set(net.parents[c])
    mb.discard(node)
    return mb


def moralized(net) -> Dict[str, set]:
    adj: Dict[str, set] = {n: set() for n in net.nodes}
    for c in net.nodes:
        ps = net.parents[c]
        for p in ps:
            adj[p].add(c)
            adj[c].add(p)
        for i in range(len(ps)):
            for j in range(i + 1, len(ps)):
                adj[ps[i]].add(ps[j])
                adj[ps[j]].add(ps[i])
    return adj


def _bfs(adj: Dict[str, set], s: str) -> Dict[str, int]:
    dist = {s: 0}
    q = deque([s])
    while q:
        v = q.popleft()
        for w in adj[v]:
            if w not in dist:
                dist[w] = dist[v] + 1
                q.append(w)
    return dist


def betweenness(adj: Dict[str, set]) -> Dict[str, float]:
    """Brandes' exact betweenness of an undirected graph, normalized as
    networkx normalizes it (by 2 / ((n - 1)(n - 2)) within the graph)."""
    nodes = list(adj)
    bc = dict.fromkeys(nodes, 0.0)
    for s in nodes:
        stack, pred = [], {v: [] for v in nodes}
        sigma = dict.fromkeys(nodes, 0.0)
        sigma[s] = 1.0
        dist = {s: 0}
        q = deque([s])
        while q:
            v = q.popleft()
            stack.append(v)
            for w in adj[v]:
                if w not in dist:
                    dist[w] = dist[v] + 1
                    q.append(w)
                if dist[w] == dist[v] + 1:
                    sigma[w] += sigma[v]
                    pred[w].append(v)
        delta = dict.fromkeys(nodes, 0.0)
        while stack:
            w = stack.pop()
            for v in pred[w]:
                delta[v] += sigma[v] / sigma[w] * (1.0 + delta[w])
            if w != s:
                bc[w] += delta[w]
    n = len(nodes)
    scale = 1.0 / ((n - 1) * (n - 2)) if n > 2 else 1.0
    return {v: b * scale for v, b in bc.items()}


def articulation_points(adj: Dict[str, set]) -> set:
    """Tarjan's cut vertices, iteratively."""
    disc: Dict[str, int] = {}
    low: Dict[str, int] = {}
    out = set()
    t = 0
    for root in adj:
        if root in disc:
            continue
        disc[root] = low[root] = t
        t += 1
        root_children = 0
        stack = [(root, None, iter(sorted(adj[root])))]
        while stack:
            v, parent, it = stack[-1]
            w = next(it, None)
            if w is None:
                stack.pop()
                if parent is not None:
                    low[parent] = min(low[parent], low[v])
                    if parent != root and low[v] >= disc[parent]:
                        out.add(parent)
                continue
            if w == parent:
                continue
            if w in disc:
                low[v] = min(low[v], disc[w])
            else:
                disc[w] = low[w] = t
                t += 1
                if v == root:
                    root_children += 1
                stack.append((w, v, iter(sorted(adj[w]))))
        if root_children > 1:
            out.add(root)
    return out


def components(adj: Dict[str, set]) -> List[set]:
    seen: set = set()
    out = []
    for v in adj:
        if v not in seen:
            comp = set(_bfs(adj, v))
            seen |= comp
            out.append(comp)
    return out


def graph_analytics(net) -> Dict:
    """Markov blankets, articulation points, betweenness and eccentricity
    of the moralized graph, per connected component."""
    adj = moralized(net)
    bc: Dict[str, float] = {}
    ecc: Dict[str, int] = {}
    art: set = set()
    for comp in components(adj):
        sub = {v: adj[v] & comp for v in adj if v in comp}
        art |= articulation_points(sub)
        bc.update(betweenness(sub))
        for v in sub:
            ecc[v] = max(_bfs(sub, v).values())
    return {"mb": {n: markov_blanket(net, n) for n in net.nodes},
            "articulation": art, "betweenness": bc, "eccentricity": ecc}


def _jaccard_dist(a: set, b: set) -> float:
    union = len(a | b)
    return 1.0 - (len(a & b) / union) if union else 0.0


def _pac_diverse(cands, ctx, k, selected):
    out: List[str] = []
    dists: List[float] = []
    pool = [c for c in cands if c not in selected]
    for cand in pool:
        if len(out) >= k:
            break
        base = selected + out
        if not base:
            out.append(cand)
            continue
        dmin = min(_jaccard_dist(ctx[cand], ctx[s]) for s in base)
        thr = (sum(dists) / len(dists)) if dists else 0.0
        if dmin >= thr:
            out.append(cand)
            dists.append(dmin)
    for cand in pool:
        if len(out) >= k:
            break
        if cand not in out:
            out.append(cand)
    return out


def select_targets(net, n_targets: int, rng) -> List[str]:
    """Category-budgeted PAC-diverse targets: hub, articulation, central,
    peripheral and random pools, each filtered by Markov-blanket
    diversity."""
    an = graph_analytics(net)
    mb = an["mb"]
    shuffled = list(net.nodes)
    rng.shuffle(shuffled)
    cats = {
        "hub": sorted(net.nodes, key=lambda n: len(mb[n]), reverse=True),
        "articulation": sorted(
            an["articulation"],
            key=lambda n: (-an["betweenness"].get(n, 0.0), n)),
        "central": sorted(net.nodes, key=lambda n: an["betweenness"].get(n, 0.0),
                          reverse=True),
        "periphery": sorted(net.nodes, key=lambda n: an["eccentricity"].get(n, 0),
                            reverse=True),
        "random_pac": shuffled,
    }
    names = list(cats)
    base, rem = divmod(n_targets, len(names))
    budgets = {c: base for c in names}
    for c in names[:rem]:
        budgets[c] += 1
    picks: List[str] = []
    spill = 0
    for c in names:
        want = budgets[c] + spill
        got = _pac_diverse(cats[c], mb, want, picks)
        picks += got
        spill = want - len(got)
    if len(picks) < n_targets:
        for n in cats["hub"]:
            if len(picks) >= n_targets:
                break
            if n not in picks:
                picks.append(n)
    return picks[:n_targets]


def _evidence_pool(net, target: str, task: str) -> List[str]:
    return sorted((ancestors(net, target) if task == "prediction"
                   else descendants(net, target))
                  or (set(net.nodes) - {target}))


def discrete_queries(net, manifold: Dict[str, np.ndarray], n_queries: int,
                     seed: int, evidence_modes: Tuple[str, ...],
                     max_evidence: int = 3) -> List[InferenceQuery]:
    """The discrete Stage II mix; ``manifold`` holds ancestral rows of the
    network (the original drew them inside, from ``seed + 1``)."""
    rng = np.random.default_rng(seed)
    n_targets = min(len(net.nodes), max(2, n_queries // 8))
    targets = select_targets(net, n_targets, rng)
    queries: List[InferenceQuery] = []
    qid = 0
    n_rows = len(next(iter(manifold.values())))
    while len(queries) < n_queries:
        target = targets[qid % len(targets)]
        mode = evidence_modes[qid % len(evidence_modes)]
        task = "prediction" if qid % 2 == 0 else "diagnosis"
        pool = _evidence_pool(net, target, task)
        if mode == "empty" or not pool:
            evidence: Dict[str, float] = {}
        else:
            k = int(rng.integers(1, min(max_evidence, len(pool)) + 1))
            ev_nodes = [str(v) for v in rng.choice(pool, size=k, replace=False)]
            if mode == "on_manifold":
                row = int(rng.integers(0, n_rows))
                evidence = {n: int(manifold[n][row]) for n in ev_nodes}
            else:
                evidence = {n: int(rng.integers(0, net.card(n)))
                            for n in ev_nodes}
        queries.append(InferenceQuery(target, evidence))
        qid += 1
    return queries


def gaussian_queries(net, manifold: Dict[str, np.ndarray], n_queries: int,
                     seed: int, evidence_modes: Tuple[str, ...],
                     max_evidence: int = 3) -> List[InferenceQuery]:
    """The Gaussian Stage II mix: on-manifold values from ancestral rows,
    off-manifold ones 2-4 marginal sigmas out, rounded to 4 places."""
    rng = np.random.default_rng(seed)
    stds = {v: net.marginal_std(v) for v in net.nodes}
    mus, _ = net.system()
    mu = dict(zip(net.nodes, mus))
    targets = [str(v) for v in rng.choice(
        net.nodes, size=min(len(net.nodes), max(2, n_queries // 8)),
        replace=False)]
    queries: List[InferenceQuery] = []
    qid = 0
    n_rows = len(next(iter(manifold.values())))
    while len(queries) < n_queries:
        target = targets[qid % len(targets)]
        mode = evidence_modes[qid % len(evidence_modes)]
        task = "prediction" if qid % 2 == 0 else "diagnosis"
        pool = _evidence_pool(net, target, task)
        if mode == "empty" or not pool:
            evidence: Dict[str, float] = {}
        else:
            k = int(rng.integers(1, min(max_evidence, len(pool)) + 1))
            ev_nodes = [str(v) for v in rng.choice(pool, size=k, replace=False)]
            if mode == "on_manifold":
                row = int(rng.integers(0, n_rows))
                evidence = {v: round(float(manifold[v][row]), 4)
                            for v in ev_nodes}
            else:
                evidence = {v: round(float(
                    mu[v] + rng.choice([-1.0, 1.0]) * rng.uniform(2.0, 4.0)
                    * stds[v]), 4) for v in ev_nodes}
        queries.append(InferenceQuery(target, evidence))
        qid += 1
    return queries
