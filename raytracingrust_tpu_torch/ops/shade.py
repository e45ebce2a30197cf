"""Mix resolution (raytracingrust_tpu/ops/shade.py ``resolve_mix``).

A MixMaterial picks its first child when the bounce's coin of its nesting
level is at least its factor, else its second (lib/materials.rs:149-156).
A hit's material id resolves in ``MAX_MIX_DEPTH`` masked lookup rounds, one
coin each, the bounce's uniform columns 0 .. 3; a non-mix row points at
itself, so a resolved id is a fixed point.  Kernel #5 (csrc/bvh_forward.cu)
runs the same rounds over the same table.
"""

from __future__ import annotations

import torch

from ..models import materials as M


def resolve_mix(mats: M.MaterialTable, mat_id: torch.Tensor,
                coins) -> torch.Tensor:
    """(R,) material ids -> (R,) leaf material ids.  ``coins``: the
    bounce's first ``MAX_MIX_DEPTH`` uniform columns, each (R,)."""
    mat_id = mat_id.long()
    for level in range(M.MAX_MIX_DEPTH):
        is_mix = mats.kind[mat_id] == M.MIX
        pick_first = coins[level] >= mats.mix_factor[mat_id]
        child = torch.where(pick_first, mats.mix_first[mat_id],
                            mats.mix_second[mat_id]).long()
        mat_id = torch.where(is_mix, child, mat_id)
    return mat_id


def mix_depth(mats: M.MaterialTable) -> int:
    """The deepest nesting of the table's mix DAG (0 without mixes);
    ``MAX_MIX_DEPTH + 1`` for a deeper chain or a cycle (the JAX
    ``_mix_depth``)."""
    kind = mats.kind.tolist()
    first, second = mats.mix_first.tolist(), mats.mix_second.tolist()

    def depth(m, hops):
        if kind[m] != M.MIX:
            return 0
        if hops > M.MAX_MIX_DEPTH:
            return M.MAX_MIX_DEPTH + 1
        return 1 + max(depth(first[m], hops + 1), depth(second[m], hops + 1))

    return max((depth(m, 0) for m in range(len(kind))), default=0)


def reachable_kinds(mats: M.MaterialTable, roots) -> set:
    """The leaf material kinds reachable from the material ids ``roots``
    through the mix DAG (the JAX ``_bvh_kinds``)."""
    kind = mats.kind.tolist()
    first, second = mats.mix_first.tolist(), mats.mix_second.tolist()
    out, seen, stack = set(), set(), torch.as_tensor(roots).unique().tolist()
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        if kind[m] == M.MIX:
            stack += [first[m], second[m]]
        else:
            out.add(kind[m])
    return out
