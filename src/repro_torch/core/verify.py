"""Schedule verifier — so far only its generic cycle finder.

:func:`find_cycle` names the witness cycle when
``schedule.stream_interleaved_order`` gets stuck and when
``backends._assert_dispatch_order`` finds a dependency edge pointing
forward. The rest of the JAX package's static verifier (races, counter
liveness, descriptor lint, slot bounds) is ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from typing import (Callable, Dict, Hashable, Iterable, List, Optional,
                    TypeVar)

_Node = TypeVar("_Node", bound=Hashable)


def find_cycle(nodes: Iterable[_Node],
               succ: Callable[[_Node], Iterable[_Node]]
               ) -> Optional[List[_Node]]:
    """First cycle of the directed graph ``(nodes, succ)`` as a node
    list (closed: witness[0] is where the cycle re-enters), or None when
    acyclic. Iterative DFS — programs can be thousands of ops deep."""
    color: Dict[_Node, int] = {}             # 1 = on stack, 2 = done
    for root in nodes:
        if color.get(root):
            continue
        path: List[_Node] = []
        stack: List[tuple] = [(root, iter(tuple(succ(root))))]
        color[root] = 1
        path.append(root)
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                c = color.get(nxt)
                if c == 1:                    # back edge: cycle
                    return path[path.index(nxt):] + [nxt]
                if c is None:
                    color[nxt] = 1
                    path.append(nxt)
                    stack.append((nxt, iter(tuple(succ(nxt)))))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                path.pop()
                stack.pop()
    return None
