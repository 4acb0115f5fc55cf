"""Shared AST helpers for kllms-check rules (stdlib-only)."""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator, List, Optional

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def dotted(node: ast.AST) -> Optional[str]:
    """``self._pool.allocator._lock`` for a Name/Attribute chain, else None.
    A call in the chain (``self.pool().lock``) breaks resolution on purpose —
    rules only reason about stable attribute paths."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_same_scope(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested function/class bodies.
    The root's own children are always visited (so a FunctionDef root yields
    its body, but defs nested inside it do not)."""
    stack: List[ast.AST] = [node]
    while stack:
        cur = stack.pop()
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, _SCOPE_NODES):
                continue
            stack.append(child)
            yield child


@dataclass
class FuncInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    name: str
    class_name: Optional[str]  # immediate enclosing class, if a method
    qualname: str
    nested: bool  # defined inside another function


def functions_in(tree: ast.AST) -> List[FuncInfo]:
    """Every function/method in a module, with its immediate class context."""
    out: List[FuncInfo] = []

    def visit(node: ast.AST, class_name: Optional[str], prefix: str, in_func: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                out.append(
                    FuncInfo(
                        node=child,
                        name=child.name,
                        class_name=class_name,
                        qualname=qual,
                        nested=in_func,
                    )
                )
                # Nested defs lose the class binding (their `self` is a closure
                # variable at best) but keep the qualname trail.
                visit(child, None, f"{qual}.", True)
            elif isinstance(child, ast.ClassDef):
                visit(child, child.name, f"{prefix}{child.name}.", in_func)
            else:
                visit(child, class_name, prefix, in_func)

    visit(tree, None, "", False)
    return out


def decorator_names(node: ast.AST) -> List[str]:
    names: List[str] = []
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        d = dotted(target)
        if d:
            names.append(d)
    return names
