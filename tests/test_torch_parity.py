"""The port's public surface against the JAX package's.

Every public module, function, class, method and module- or class-level
alias of ``ddm_tpu/`` is read with ``ast`` (this file imports nothing of
the JAX package, and no ``jax``) and looked up in the ``ddm_tpu_torch``
module at the same relative path with ``getattr``, so names that a port
class inherits count.  For every function and method the JAX package's
parameter names, their positions and their defaults must be the port's,
unless ``PARITY_EXCEPTIONS`` lists the item with one of these categories:

- ``jit``: a JAX ``jit`` or ``Partial`` wrapper, which eager PyTorch needs
  no counterpart of;
- ``tpu``: a TPU workaround; the reason names the config key, if any, and
  the exact-f64 path the port takes in its place;
- ``gspmd``: GSPMD sharding machinery, replaced by ``torch.distributed`` in
  ``core/mesh.py``;
- ``kernel``: a Pallas kernel; the third field names the port's kernel
  wrapper, which must exist;
- ``renamed``: the port's counterpart under another name; the third field
  names it (a dotted path for a name, a parameter of the port's function
  for a parameter) and it must exist.

Parameters that only the port has (``device``, ``symmetrize``, ...) need no
entry; one with a default may not stand before a parameter that both
packages take by position, where a JAX-style positional call would fill
it.  Dataclass fields are data layouts and are not compared.

Keys: ``ddm_tpu.<module>`` for a module, ``ddm_tpu.<module>.<name>[.<method>]``
for a name, and ``...(<parameter>)`` for a parameter.
"""

from __future__ import annotations

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CATEGORIES = {"jit", "tpu", "gspmd", "kernel", "renamed"}

_ENGINE = ("the port's scopes synchronize the card they are given "
           "(ScopedLog device=)")
PARITY_EXCEPTIONS = {
    # -- whole modules ----------------------------------------------------
    "ddm_tpu.core.boxnd": (
        "tpu", "rect/box canvases for the TPU's tiled layout; the port "
        "extracts and scatters through index maps (core/indexmaps.py)"),
    "ddm_tpu.core.structured": (
        "tpu", "rect canvases for the TPU's tiled layout; no config key, "
        "the port takes the general extraction (precond/extract.py)"),
    "ddm_tpu.core.xfer": (
        "tpu", "flat host-to-device uploads around the TPU's tiled-layout "
        "transfer padding; the port uploads with torch.as_tensor"),
    # -- the one Pallas kernel --------------------------------------------
    "ddm_tpu.kernels.ddmatvec.dd_matvec_pallas": (
        "kernel", "the Pallas double-single matvec is the hand-written "
        "CUDA kernel csrc/dd_matvec.cu", "ddm_tpu_torch.kernels.ddmatvec."
        "dd_matvec_cuda"),
    # -- api --------------------------------------------------------------
    "ddm_tpu.api.build_preconditioner(axis)": (
        "gspmd", "the shard_map mesh axis name; mesh= takes a "
        "core.mesh.SubdomainMesh of torch.distributed ranks"),
    "ddm_tpu.api.solve(axis)": (
        "gspmd", "the shard_map mesh axis name; mesh= takes a "
        "core.mesh.SubdomainMesh"),
    # -- core -------------------------------------------------------------
    "ddm_tpu.core.mesh.subdomain_mesh(n_devices)": (
        "gspmd", "a jax Mesh over n devices; the port's mesh is the "
        "initialized process group (group=, device=)"),
    "ddm_tpu.core.mesh.subdomain_mesh(axis)": (
        "gspmd", "the jax Mesh axis name"),
    "ddm_tpu.core.mesh.setup_sharding.__init__(axis)": (
        "gspmd", "the jax Mesh axis name; the port's takes n_sub"),
    "ddm_tpu.core.mesh.solve_sharded(axis)": (
        "gspmd", "the shard_map axis name"),
    "ddm_tpu.core.mesh.batched": (
        "gspmd", "commits an array to the subdomain sharding; a rank "
        "holds its slab (core.mesh.local_rows)"),
    "ddm_tpu.core.mesh.with_axis": (
        "gspmd", "sets the shard_map axis on a preconditioner; the port's "
        "preconditioners hold their SubdomainMesh"),
    "ddm_tpu.core.mesh.batch_specs": (
        "gspmd", "PartitionSpecs for shard_map; no counterpart under "
        "torch.distributed"),
    "ddm_tpu.core.mesh.replicated_specs": (
        "gspmd", "PartitionSpecs for shard_map"),
    "ddm_tpu.core.mesh.shard_batched": (
        "gspmd", "device_put over the mesh; ranks cut their slab in "
        "core.mesh.setup_sharding"),
    "ddm_tpu.core.sparse.tiled_take": (
        "tpu", "a gather tiled for the TPU's vector layout; the port "
        "indexes with torch's gather"),
    "ddm_tpu.core.sparse.maybe_tiled_take": (
        "tpu", "chooses tiled_take on the TPU; the port indexes with "
        "torch's gather"),
    # -- eigen ------------------------------------------------------------
    "ddm_tpu.eigen.dense_gevp.solve_gevp_dense_jit": (
        "jit", "jax.jit of the dense GEVP"),
    "ddm_tpu.eigen.dense_gevp.solve_gevp_dense_auto": (
        "tpu", "the speculative staged-whitening GEVP (config key "
        "eigensolver.whiten); the port runs the exact f64 Cholesky "
        "congruence of solve_gevp_dense"),
    "ddm_tpu.eigen.dense_gevp.solve_gevp_dense(whiten)": (
        "tpu", "a staged-whitening factor (eigensolver.whiten); the port "
        "always takes the exact f64 Cholesky congruence"),
    "ddm_tpu.eigen.dense_gevp.solve_gevp_dense(metric_mat)": (
        "tpu", "the whitened metric of the staged path (eigensolver."
        "whiten); the exact congruence needs none"),
    # -- fem --------------------------------------------------------------
    "ddm_tpu.fem.assemble.eval_coefficient": (
        "tpu", "evaluates coefficients on the host CPU because the TPU's "
        "emulated f64 flips discontinuities; the port evaluates in IEEE "
        "f64 where the data lives"),
    "ddm_tpu.fem.subassembly.subdomain_element_lists": (
        "renamed", "the element wrapper of subdomain_stamp_lists; the "
        "port calls that with the discretization's dof tuples",
        "ddm_tpu_torch.fem.subassembly.subdomain_stamp_lists"),
    "ddm_tpu.fem.subassembly.neumann_dense(sub_elems)": (
        "renamed", "the port sums element entries through a fixed-order "
        "SumPlan that neumann_plan builds from sub_elems and sub_locs "
        "(deterministic, no float atomics)", "plan"),
    "ddm_tpu.fem.subassembly.neumann_dense(sub_locs)": (
        "renamed", "see sub_elems", "plan"),
    "ddm_tpu.fem.subassembly.scale_matrix_with_pou(donate)": (
        "renamed", "JAX buffer donation is the port's in-place update",
        "inplace"),
    # -- obs --------------------------------------------------------------
    "ddm_tpu.obs.logger.hard_sync": (
        "tpu", "a device-to-host fetch because block_until_ready does not "
        "block on the TPU backend; " + _ENGINE),
    "ddm_tpu.obs.logger.Logger.end_event(block_on)": (
        "tpu", "hard_sync's TPU fetch; " + _ENGINE),
    "ddm_tpu.obs.logger.ScopedLog.__init__(block_on)": (
        "renamed", "arrays to block on; the port synchronizes the device "
        "they live on", "device"),
    # -- precond ----------------------------------------------------------
    "ddm_tpu.precond.extract.rect_extract_ok": (
        "tpu", "guards the rect canvas extraction; the port always takes "
        "the general extraction"),
    "ddm_tpu.precond.extract.extract_subdomain_dense(rect)": (
        "tpu", "the rect canvas of the topology; the port always takes "
        "the general extraction"),
    "ddm_tpu.precond.extract.scatter_add_subdomain_shard": (
        "gspmd", "the scatter-add over shard_map's axis; the port's "
        "applies all-gather the slabs (core.mesh.SubdomainMesh)"),
    "ddm_tpu.precond.extract.scatter_add_subdomain(sub2glob)": (
        "renamed", "the port always sums through the fixed-order gather-"
        "dual map that core.indexmaps.dual_scatter_map builds from "
        "sub2glob and n_glob (no float atomics), so dualT is required",
        "dualT"),
    "ddm_tpu.precond.extract.scatter_add_subdomain(n_glob)": (
        "renamed", "see sub2glob", "dualT"),
    "ddm_tpu.precond.galerkin.galerkin_coarse_matrix(group)": (
        "tpu", "group = 1 is the TPU's compiled scan of one subdomain per "
        "step; the port's None sizes the groups to a 256 MiB block, the "
        "same matrix"),
    # -- solvers ----------------------------------------------------------
    "ddm_tpu.solvers.direct.BatchedQR": (
        "tpu", "QR stands in for LU where the TPU has no f64 LU; the port "
        "factors subdomain_solver.type = qr by LU"),
    "ddm_tpu.solvers.direct.bmv": (
        "tpu", "the multiply+reduce matvec idiom for the TPU; the port "
        "uses torch's batched matmul"),
    "ddm_tpu.solvers.direct.dd_matmul": (
        "tpu", "the MXU double-single matmul of setup-time refinement; "
        "the port refines in f64"),
    "ddm_tpu.solvers.direct.cholesky_batched": (
        "tpu", "caps the batch at 96 around a TPU Cholesky bug; the port "
        "calls torch.linalg.cholesky in slabs of batch_chunk_size"),
    "ddm_tpu.solvers.direct.factor_batched_jit": (
        "jit", "a cached jax.jit of factor_batched"),
    "ddm_tpu.solvers.direct.batched_cholesky_blocked": (
        "tpu", "blocked Cholesky as square matmuls for the TPU; the port "
        "calls torch.linalg.cholesky"),
    "ddm_tpu.solvers.direct.use_blocked_tri_inv": (
        "tpu", "selects the blocked triangular inverse on the TPU; the "
        "port calls torch.linalg.solve_triangular"),
    "ddm_tpu.solvers.direct.batched_tri_lower_inv": (
        "tpu", "blocked triangular inverse for the TPU; the port calls "
        "torch.linalg.solve_triangular"),
    "ddm_tpu.solvers.direct.newton_inverse_batched": (
        "tpu", "the f32-seeded Newton-Schulz inverse (subdomain_solver."
        "newton_rtol, coarse_solver.newton_rtol); the port forms the "
        "exact f64 inverse and ignores the keys"),
    "ddm_tpu.solvers.direct.staged_whiten_estimate": (
        "tpu", "staged whitening (eigensolver.whiten); the port takes the "
        "exact f64 Cholesky congruence"),
    "ddm_tpu.solvers.direct.staged_whiten_batched": (
        "tpu", "staged whitening (eigensolver.whiten); the port takes the "
        "exact f64 Cholesky congruence"),
    "ddm_tpu.solvers.krylov.operator_of": (
        "jit", "a jax.tree_util.Partial around .mv for jitted solvers; the "
        "port passes the bound method"),
    "ddm_tpu.solvers.krylov.prec_of": (
        "jit", "a Partial around a preconditioner's apply"),
    "ddm_tpu.solvers.krylov.identity_prec": (
        "jit", "a Partial identity; the port's solvers take prec=None"),
    "ddm_tpu.solvers.krylov.gmres_solve(ortho)": (
        "tpu", "double-single Arnoldi dots (solver.ortho = dd); the port "
        "orthogonalizes in f64 and its bench refuses other values"),
    "ddm_tpu.solvers.krylov.fgmres_solve(ortho)": (
        "tpu", "double-single Arnoldi dots (solver.ortho = dd); the port "
        "orthogonalizes in f64"),
}


# ---------------------------------------------------------------------------
# the JAX package's surface, from its source
# ---------------------------------------------------------------------------

def _decorators(fn) -> set[str]:
    return {ast.unparse(d).split("(")[0].split(".")[-1]
            for d in fn.decorator_list}


def _params(fn, method: bool):
    """[(kind, name, default AST or None)] with kind pos / kw / var / varkw;
    a method's self or cls is left out."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [("pos", p.arg, d) for p, d in zip(pos, defaults)]
    if method and "staticmethod" not in _decorators(fn):
        out = out[1:]
    if a.vararg:
        out.append(("var", a.vararg.arg, None))
    out += [("kw", p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append(("varkw", a.kwarg.arg, None))
    return out


def _literals(tree) -> dict:
    """Module-level NAME = <literal> assignments, for defaults that name
    a constant."""
    out = {}
    for n in tree.body:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)):
            try:
                out[n.targets[0].id] = ast.literal_eval(n.value)
            except ValueError:
                pass
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


def _module_items(path: Path):
    """(module key, [(key, params or None, is a method)], literal
    constants) of one JAX source file; params is None for a class, a
    property or an alias."""
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    mod = ".".join(parts)
    tree = ast.parse(path.read_text())
    items = []
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(n.name):
                items.append((f"{mod}.{n.name}", _params(n, False), False))
        elif isinstance(n, ast.ClassDef) and _public(n.name):
            items.append((f"{mod}.{n.name}", None, False))
            for m in n.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if not (_public(m.name) or m.name in ("__init__",
                                                          "__call__")):
                        continue
                    prop = _decorators(m) & {"property", "cached_property",
                                             "setter"}
                    items.append((f"{mod}.{n.name}.{m.name}",
                                   None if prop else _params(m, True), True))
                elif isinstance(m, ast.Assign) and isinstance(
                        m.value, (ast.Name, ast.Attribute)):
                    items += [(f"{mod}.{n.name}.{t.id}", None, True)
                              for t in m.targets
                              if isinstance(t, ast.Name) and _public(t.id)]
        elif isinstance(n, ast.Assign) and isinstance(
                n.value, (ast.Call, ast.Name, ast.Attribute)):
            items += [(f"{mod}.{t.id}", None, False) for t in n.targets
                      if isinstance(t, ast.Name) and _public(t.id)]
    return mod, items, _literals(tree)


JAX_FILES = sorted((ROOT / "ddm_tpu").rglob("*.py"))
SURFACE = {m: (items, lits) for m, items, lits in map(_module_items,
                                                      JAX_FILES)}
# function or method key -> (its parameters, is a method)
FUNCTIONS = {key: (params, method) for items, _ in SURFACE.values()
             for key, params, method in items if params is not None}


# ---------------------------------------------------------------------------
# the port's counterparts
# ---------------------------------------------------------------------------

MISSING = object()


def _port_module(mod: str):
    return importlib.import_module("ddm_tpu_torch" + mod[len("ddm_tpu"):])


def _resolve(key: str, mod: str):
    """The port's object for a JAX key of module ``mod``, or MISSING."""
    obj = _port_module(mod)
    for attr in key[len(mod) + 1:].split("."):
        obj = getattr(obj, attr, MISSING)
        if obj is MISSING:
            break
    return obj


def _port_params(obj, method: bool):
    """[(kind, name, default or MISSING)] of the port's callable."""
    sig = inspect.signature(obj)
    kinds = {inspect.Parameter.POSITIONAL_ONLY: "pos",
             inspect.Parameter.POSITIONAL_OR_KEYWORD: "pos",
             inspect.Parameter.VAR_POSITIONAL: "var",
             inspect.Parameter.KEYWORD_ONLY: "kw",
             inspect.Parameter.VAR_KEYWORD: "varkw"}
    out = [(kinds[p.kind], p.name,
            MISSING if p.default is inspect.Parameter.empty else p.default)
           for p in sig.parameters.values()]
    if method and out and out[0][1] in ("self", "cls"):
        out = out[1:]
    return out


def _same_default(node, value, lits) -> bool:
    if node is None:
        return value is MISSING
    if value is MISSING:
        return False
    try:
        want = ast.literal_eval(node)
    except ValueError:
        if isinstance(node, ast.Name) and node.id in lits:
            want = lits[node.id]
        elif isinstance(node, ast.Attribute):  # jnp.float32 -> torch.float32
            return str(value) == f"torch.{node.attr}"
        else:
            return False
    return type(want) is type(value) and want == value


def _signature_faults(key: str, jax_params, port_obj, method: bool,
                      lits) -> list[str]:
    port = _port_params(port_obj, method)
    by_name = {name: (kind, d) for kind, name, d in port}
    # a renamed parameter counts at its position under the port's name;
    # the port's parameter it became has no JAX default to compare with
    renamed_to = {e[2] for e in (PARITY_EXCEPTIONS.get(f"{key}({n})")
                                 for _, n, _ in jax_params)
                  if e is not None and e[0] == "renamed"}
    faults, jax_pos = [], []

    def place(name):
        if not jax_pos or jax_pos[-1] != name:
            jax_pos.append(name)

    for kind, name, node in jax_params:
        entry = PARITY_EXCEPTIONS.get(f"{key}({name})")
        if entry is not None:
            if entry[0] == "renamed" and kind == "pos":
                place(entry[2])
            continue
        if kind in ("var", "varkw"):
            if not any(k == kind for k, _, _ in port):
                faults.append(f"{key}: no {'*' if kind == 'var' else '**'}"
                              f"{name}")
            continue
        if name not in by_name:
            faults.append(f"{key}: parameter {name!r} missing")
            continue
        if kind == "pos":
            place(name)
        if name not in renamed_to and not _same_default(
                node, by_name[name][1], lits):
            want = "required" if node is None else ast.unparse(node)
            got = by_name[name][1]
            faults.append(f"{key}({name}): default {want}, the port's "
                          f"{'required' if got is MISSING else repr(got)}")
    shared = set(jax_pos) | renamed_to
    port_pos = [name for kind, name, _ in port if kind == "pos"]
    if [n for n in port_pos if n in shared] != jax_pos:
        faults.append(f"{key}: positional order {jax_pos}, the port's "
                      f"{port_pos}")
    last_shared = max((i for i, n in enumerate(port_pos) if n in jax_pos),
                      default=-1)
    for i, (kind, name, d) in enumerate(p for p in port if p[0] == "pos"):
        if i < last_shared and name not in shared and d is not MISSING:
            faults.append(f"{key}({name}): a port-only parameter with a "
                          "default before a shared positional one")
    return faults


def _owner_module(key: str) -> str:
    """The JAX module of a name key: the longest module prefix."""
    return max((m for m in SURFACE if key.startswith(m + ".")), key=len)


def _module_faults(mod: str) -> list[str]:
    if mod in PARITY_EXCEPTIONS:
        return []
    try:
        _port_module(mod)
    except ImportError:
        return [f"{mod}: no module ddm_tpu_torch{mod[len('ddm_tpu'):]}"]
    items, lits = SURFACE[mod]
    faults = []
    for key, params, method in items:
        if key in PARITY_EXCEPTIONS or any(
                key.startswith(k + ".") for k in PARITY_EXCEPTIONS):
            continue
        obj = _resolve(key, mod)
        if obj is MISSING:
            faults.append(f"{key}: missing in the port")
        elif params is not None:
            faults += _signature_faults(key, params, obj, method, lits)
    return faults


@pytest.mark.parametrize("mod", sorted(SURFACE))
def test_port_has_the_jax_surface(mod):
    """Every public name of the JAX module, and every parameter of its
    functions and methods with its position and default, is the port's
    or listed in PARITY_EXCEPTIONS."""
    faults = _module_faults(mod)
    assert not faults, "\n".join(faults)


def _all_keys() -> set[str]:
    """Every module, name and parameter key of the JAX package."""
    keys = set()
    for mod, (items, _) in SURFACE.items():
        keys.add(mod)
        for key, params, _ in items:
            keys.add(key)
            keys |= {f"{key}({name})" for _, name, _ in params or ()}
    return keys


def test_manifest_entries_are_live():
    """Each PARITY_EXCEPTIONS entry names a JAX item that exists, has a
    category and a reason, names an existing target where its category
    needs one, and excuses a real difference: the port lacks the module,
    name, or a parameter entry takes away a fault that the function
    would have without it."""
    keys = _all_keys()
    stale = []
    for key, entry in list(PARITY_EXCEPTIONS.items()):
        category, reason = entry[0], entry[1]
        if category not in CATEGORIES or not reason:
            stale.append(f"{key}: category {category!r}")
        if key not in keys:
            stale.append(f"{key}: not in the JAX package")
            continue
        if "(" in key:
            fn_key = key.split("(")[0]
            mod = _owner_module(fn_key)
            obj = _resolve(fn_key, mod)
            params, method = FUNCTIONS[fn_key]
            names = {n for _, n, _ in _port_params(obj, method)}
            if category == "renamed" and entry[2] not in names:
                stale.append(f"{key}: target {entry[2]!r} missing")
            lits = SURFACE[mod][1]
            with_entry = _signature_faults(fn_key, params, obj, method, lits)
            del PARITY_EXCEPTIONS[key]
            try:
                without = _signature_faults(fn_key, params, obj, method, lits)
            finally:
                PARITY_EXCEPTIONS[key] = entry
            if without == with_entry:
                stale.append(f"{key}: excuses no difference")
            continue
        if key in SURFACE:
            try:
                _port_module(key)
                stale.append(f"{key}: the port has the module")
            except ImportError:
                pass
        elif _resolve(key, _owner_module(key)) is not MISSING:
            stale.append(f"{key}: the port has the name")
        if category in ("renamed", "kernel"):
            mod, _, attr = entry[2].rpartition(".")
            if getattr(importlib.import_module(mod), attr, MISSING) \
                    is MISSING:
                stale.append(f"{key}: target {entry[2]} missing")
    assert not stale, "\n".join(stale)


def _imports(path: Path) -> list[str]:
    """Absolute module names that a source file imports anywhere (at top
    level, inside functions, or through importlib / __import__ with a
    constant name)."""
    out = []
    for n in ast.walk(ast.parse(path.read_text())):
        if isinstance(n, ast.Import):
            out += [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            out.append(n.module)
        elif (isinstance(n, ast.Call) and ast.unparse(n.func) in (
                "importlib.import_module", "import_module", "__import__")
              and n.args and isinstance(n.args[0], ast.Constant)):
            out.append(str(n.args[0].value))
    return out


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of ddm_tpu_torch, and not chip_smoke.py, imports jax,
    jaxlib or ddm_tpu, not even lazily inside a function."""
    files = sorted((ROOT / "ddm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [f"{f.relative_to(ROOT)}: {m}" for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "ddm_tpu")]
    assert len(files) > 60 and not bad, "\n".join(bad)
