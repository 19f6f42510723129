"""``chip_smoke.py``'s iteration limits against its table of the JAX
package's full-size counts, read with ``ast`` (nothing is imported or run):
every full-size path of ``MAIN_PATHS``, ``NEWTON_PATHS`` and ``CLI_PATHS``
has a limit, and each limit is its JAX path's recorded count
(``JAX_FULL_SIZE``) + 2, or + a margin that states its reason, or the path
stands in ``UNMEASURED`` with the reason it has no JAX run.  The
full-size runs themselves are ``tests/test_torch_fullsize.py`` (slow)."""

import ast
import functools
import os

import pytest

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "chip_smoke.py")


@functools.lru_cache(maxsize=None)
def module():
    with open(SMOKE) as f:
        return ast.parse(f.read())


def assigned(name):
    """The value node of the module-level assignment to ``name``."""
    for node in module().body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return node.value
    raise KeyError(name)


def literal(name):
    """The value of the module-level assignment to ``name``: a literal, or
    an expression of literals and other such names."""
    node = assigned(name)
    names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
    code = compile(ast.Expression(node), SMOKE, "eval")
    return eval(code, {"__builtins__": {}}, {n: literal(n) for n in names})


def keys(name):
    return [ast.literal_eval(k) for k in assigned(name).keys]


def full_size_paths():
    return (list(literal("MAIN_PATHS")) + keys("NEWTON_PATHS")
            + keys("CLI_PATHS"))


@pytest.mark.parametrize("path", full_size_paths())
def test_every_full_size_path_has_a_reference_limit(path):
    jax, limit_of, unmeasured = (literal("JAX_FULL_SIZE"), literal("LIMIT_OF"),
                                 literal("UNMEASURED"))
    if path in unmeasured:
        assert path not in limit_of
        assert isinstance(unmeasured[path], str) and unmeasured[path].strip()
        return
    ref, margin, why = limit_of[path]
    iterations, true_res, how = jax[ref]
    assert isinstance(iterations, int) and iterations > 0
    assert isinstance(true_res, float) and true_res > 0 and how.strip()
    assert margin == 2 or (0 < margin and why.strip())
    if path in keys("NEWTON_PATHS") and path == ref:
        inner = literal("JAX_NEWTON_INNER")[ref]
        assert len(inner) == iterations and all(k > 0 for k in inner)


def test_limits_derive_from_the_table_alone():
    """``MAX_ITERS`` is built from ``LIMIT_OF`` and ``JAX_FULL_SIZE`` only,
    every later write to it goes through ``hold_to_run`` (which can only
    lower a limit), and the table holds no stale entry."""
    comp = assigned("MAX_ITERS")
    assert isinstance(comp, ast.DictComp)
    names = {n.id for n in ast.walk(comp) if isinstance(n, ast.Name)}
    assert {"LIMIT_OF", "JAX_FULL_SIZE"} <= names
    assert not names & {"MAIN_PATHS", "CLI_PATHS", "NEWTON_PATHS"}
    writers = set()
    for fn in ast.walk(module()):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target] if isinstance(node, ast.AugAssign)
                           else [])
                if any(isinstance(t, ast.Subscript)
                       and isinstance(t.value, ast.Name)
                       and t.value.id == "MAX_ITERS" for t in targets):
                    writers.add(fn.name)
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "MAX_ITERS"):
                    writers.add(fn.name)
    assert writers == {"hold_to_run"}
    paths = set(full_size_paths())
    limit_of, jax = literal("LIMIT_OF"), literal("JAX_FULL_SIZE")
    assert set(limit_of) <= paths
    assert {ref for ref, _, _ in limit_of.values()} == set(jax)
    assert set(literal("UNMEASURED")) <= paths
