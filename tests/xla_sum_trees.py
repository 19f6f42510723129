"""Print the order in which XLA's CPU backend sums each contraction of the
JAX package's element assembly, the table ``_SUM_TREES`` of
``ddm_tpu_torch/fem/assemble.py`` reproduces.

    python tests/xla_sum_trees.py quad Ke        # one element type, one stage
    python tests/xla_sum_trees.py all            # every type and stage

For a contraction of K terms, every term is set to 1 but a pair, set to
+M and -M with M = 2^60 (so that 1 + M rounds to M): the result then
counts the ones that XLA adds outside the lowest common subtree of the
pair, which gives that subtree's size.  The sizes of all pairs give the
summation tree by agglomeration (FPRev's method).  Every output entry gets
its own tree: entries that XLA takes as a remainder of its tiling show as
a second tree.  Whether a node is a fused multiply-add does not show with
these exact products; the table's fused flags come from comparing both
forms with the JAX package's results on random meshes
(``tests/test_torch_assembly_bitwise.py``).

Leaves are printed in the order of the contracted indices as they stand in
the operand that carries the terms (``Ke``: point q, then axis g, k = q *
d + g; the table lists (g, q) instead).  Runs on the CPU with x64.
"""

import itertools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

M = 2.0 ** 60
# element type -> (points q, nodes i, dimension d)
TYPES = {"quad": (4, 4, 2), "tri": (3, 3, 2), "hex": (8, 8, 3),
         "tet": (4, 4, 3), "tri2": (6, 6, 2), "quad2": (9, 9, 2)}
# stage -> (einsum of the JAX package's assembly, operand carrying the terms)
STAGES = {
    "J": ("qid,eig->eqgd", 0), "grads": ("qid,eqdg->eqig", 0),
    "Ke": ("eq,eqig,eqjg->eij", 1), "c": ("eq,qi,qj->eij", 0),
    "fe": ("eq,qi->ei", 0), "b_d": ("eqjd,eqd->eqj", 0),
    "b_q": ("eqj,qi->eji", 0), "gg": ("eqig,eqjg->eqij", 0),
    "Kel": ("eq,eqijck->eijck", 0), "fel": ("eq,qi,eqc->eic", 0),
}
N_ELEMENTS = 200


def lca_sizes(spec, sizes, vop):
    """(K, K, *out) subtree sizes of every term pair at every output entry,
    and the contracted indices."""
    ins, out = spec.split("->")
    ops = ins.split(",")
    contracted = [c for c in dict.fromkeys(ins.replace(",", ""))
                  if c not in out]
    vspec = ops[vop]
    cidx = [c for c in vspec if c in contracted]
    kshape = [sizes[c] for c in cidx]
    K = int(np.prod(kshape))
    f = jax.jit(lambda *a: jnp.einsum(spec, *a))
    L = np.zeros((K, K) + tuple(sizes[c] for c in out))
    order = cidx + [c for c in vspec if c not in cidx]
    for a, b in itertools.combinations(range(K), 2):
        v = np.ones(K)
        v[a], v[b] = M, -M
        full = np.broadcast_to(
            v.reshape(kshape + [1] * (len(vspec) - len(cidx))),
            [sizes[c] for c in order])
        arr = np.transpose(full, [order.index(c) for c in vspec]).copy()
        args = [arr if i == vop else np.ones([sizes[c] for c in o])
                for i, o in enumerate(ops)]
        L[a, b] = L[b, a] = K - np.asarray(f(*map(jnp.asarray, args)))
    return L, cidx


def tree_of(sizes2d):
    """The binary summation tree of one output entry, as nested pairs."""
    K = sizes2d.shape[0]
    clusters = {i: (i,) for i in range(K)}
    nodes = {i: i for i in range(K)}
    while len(clusters) > 1:
        best = None
        for x, y in itertools.combinations(list(clusters), 2):
            s = max(sizes2d[a, b] for a in clusters[x] for b in clusters[y])
            if best is None or s < best[0]:
                best = (s, x, y)
        _, x, y = best
        new = max(nodes) + 1
        nodes[new] = (nodes[x], nodes[y])
        clusters[new] = clusters.pop(x) + clusters.pop(y)
    return nodes[max(nodes)]


def trees(elem_type, stage):
    q, i, d = TYPES[elem_type]
    spec, vop = STAGES[stage]
    sizes = dict(e=N_ELEMENTS, q=q, i=i, j=i, g=d, d=d, k=d, c=d)
    L, cidx = lca_sizes(spec, sizes, vop)
    K = L.shape[0]
    flat = L.reshape(K, K, -1)
    out = {}
    for p in range(flat.shape[2]):
        out.setdefault(repr(tree_of(flat[:, :, p])), []).append(p)
    return out, cidx


def main(argv):
    if argv[:1] == ["all"]:
        pairs = [(t, s) for t in TYPES for s in STAGES
                 if not (t in ("tri2", "quad2") and s in ("gg", "Kel", "fel"))]
    else:
        pairs = [(argv[0], argv[1])]
    for elem_type, stage in pairs:
        out, cidx = trees(elem_type, stage)
        print(f"{elem_type} {stage} over {cidx}: {len(out)} tree(s)")
        for t, entries in out.items():
            print(f"  {len(entries)} entries (first {entries[:4]}): {t}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
