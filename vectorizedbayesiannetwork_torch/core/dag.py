"""Static DAG with host-side structural precomputation, without networkx.

Counterpart of ``vectorizedbayesiannetwork_tpu/core/dag.py``. The machine
that runs the port has no networkx, so the graph is read from an
``nx.DiGraph`` (or any object with ``predecessors``/``successors``), any
object with ``.nodes``/``.edges``, a list of ``(parent, child)`` edges, or
a ``{node: [parents]}`` dict. The topological order is computed here by
Kahn's algorithm in generations, in the same order as
``networkx.topological_sort``: roots in node order, and each generation's
children in the order of their parents' child lists. Parent lists keep
networkx's order, which fixes the mixed-radix layout of categorical CPTs.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple


def _read_graph(graph):
    """(nodes, parents, children), each list in networkx's order.

    networkx keeps a node's parents in the order their edges were added and
    its children likewise, so a graph with ``predecessors``/``successors``
    is read through them; other inputs add their edges in listed order.
    """
    if hasattr(graph, "predecessors") and hasattr(graph, "successors"):
        nodes = list(graph.nodes)
        return (
            nodes,
            {n: list(graph.predecessors(n)) for n in nodes},
            {n: list(graph.successors(n)) for n in nodes},
        )
    if isinstance(graph, dict):
        nodes = list(graph)
        edges = [(p, n) for n in graph for p in graph[n]]
    elif hasattr(graph, "edges"):
        edges_src = graph.edges() if callable(graph.edges) else graph.edges
        edges = [tuple(e[:2]) for e in edges_src]
        nodes_src = getattr(graph, "nodes", ())
        nodes = list(nodes_src() if callable(nodes_src) else nodes_src)
    else:
        edges = [tuple(e[:2]) for e in graph]
        nodes = []
    order: Dict[str, None] = dict.fromkeys(nodes)
    for u, v in edges:
        order.setdefault(u)
        order.setdefault(v)
    parents: Dict[str, List[str]] = {n: [] for n in order}
    children: Dict[str, List[str]] = {n: [] for n in order}
    for u, v in dict.fromkeys(edges):  # a repeated edge counts once
        children[u].append(v)
        parents[v].append(u)
    return list(order), parents, children


class StaticDAG:
    def __init__(self, graph) -> None:
        if isinstance(graph, StaticDAG):
            nodes = list(graph._nodes)
            parents = {n: list(graph._parents[n]) for n in nodes}
            children = {n: list(graph._children[n]) for n in nodes}
        else:
            nodes, parents, children = _read_graph(graph)
        self._nodes = tuple(nodes)
        self._edges = tuple((u, v) for u in nodes for v in children[u])
        indeg = {n: len(parents[n]) for n in nodes}
        generation = [n for n in nodes if indeg[n] == 0]
        topo: List[str] = []
        while generation:
            topo.extend(generation)
            nxt = []
            for node in generation:
                for child in children[node]:
                    indeg[child] -= 1
                    if indeg[child] == 0:
                        nxt.append(child)
            generation = nxt
        if len(topo) != len(nodes):
            raise ValueError("Graph must be a DAG")
        self._topo: Tuple[str, ...] = tuple(topo)
        self._parents = {n: tuple(parents[n]) for n in topo}
        self._children = {n: tuple(children[n]) for n in topo}
        level: Dict[str, int] = {}
        for node in topo:
            level[node] = 1 + max((level[p] for p in self._parents[node]),
                                  default=-1)
        levels: List[List[str]] = [[] for _ in range(1 + max(level.values(),
                                                             default=0))]
        for node in topo:
            levels[level[node]].append(node)
        self._levels = tuple(tuple(lv) for lv in levels)
        self._level_of = level

    def nodes(self) -> Tuple[str, ...]:
        return self._topo

    def edges(self) -> Tuple[Tuple[str, str], ...]:
        """Edges grouped by source in node-insertion order, as networkx."""
        return self._edges

    def topological_order(self) -> Tuple[str, ...]:
        return self._topo

    def topological_levels(self) -> Tuple[Tuple[str, ...], ...]:
        """Maximal antichains in topological order: level(n) = 1 + the
        deepest level of n's parents, roots 0."""
        return self._levels

    def parents(self, node: str) -> Tuple[str, ...]:
        return self._parents[node]

    def children(self, node: str) -> Tuple[str, ...]:
        return self._children[node]

    def level_of(self, node: str) -> int:
        return self._level_of[node]

    def _reach(self, node: str, step: Dict[str, Tuple[str, ...]]) -> Set[str]:
        seen: Set[str] = set()
        stack = list(step[node])
        while stack:
            n = stack.pop()
            if n not in seen:
                seen.add(n)
                stack.extend(step[n])
        return seen

    def descendants(self, node: str) -> Set[str]:
        """Every node reachable from ``node`` (itself excluded)."""
        return self._reach(node, self._children)

    def ancestors(self, node: str) -> Set[str]:
        """Every node from which ``node`` is reachable (itself excluded)."""
        return self._reach(node, self._parents)

    def __contains__(self, node: str) -> bool:
        return node in self._parents

    def __len__(self) -> int:
        return len(self._topo)


class TemporalDAG:
    """Placeholder for temporal DAG support, as in the JAX package."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("TemporalDAG is not implemented yet")


class DynamicDAG:
    """Placeholder for dynamic DAG support, as in the JAX package."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("DynamicDAG is not implemented yet")
