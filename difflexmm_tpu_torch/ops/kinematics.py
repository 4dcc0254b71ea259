"""Free/constrained DOF bookkeeping (counterpart of ``DOFSet`` in
``difflexmm_tpu/ops/kinematics.py``)."""

import numpy as np


class DOFSet:
    """Static free/constrained DOF bookkeeping as host (numpy) data.

    Attrs:
        free_mask: (n_blocks, 3) float64, 1 on free DOFs, 0 on constrained.
        constrained_blocks / constrained_dofs: (k,) int64 pair indices, in
            the order the pairs were given.
        n_constrained: number of constrained [block, DOF] pairs.
    """

    def __init__(self, n_blocks: int, constrained_block_DOF_pairs):
        pairs = np.asarray(constrained_block_DOF_pairs, dtype=np.int64).reshape(-1, 2)
        mask = np.ones((n_blocks, 3))
        mask[pairs[:, 0], pairs[:, 1]] = 0.0
        self.n_blocks = int(n_blocks)
        self.n_constrained = len(pairs)
        self.free_mask = mask
        self.constrained_blocks = pairs[:, 0].copy()
        self.constrained_dofs = pairs[:, 1].copy()

    def last_write_pairs(self):
        """Deduplicated ``(blocks, dofs, pair_ids)``: for each constrained
        [block, DOF] slot, the index of the LAST pair that targets it — the
        last-write-wins rule of the JAX scatter (``.at[].set``, and
        ``combine="last"`` of the Pallas drive scatter). Sorted by slot."""

        last = {}
        for c, (b, d) in enumerate(zip(self.constrained_blocks, self.constrained_dofs)):
            last[(int(b), int(d))] = c
        slots = sorted(last)
        blocks = np.array([b for b, _ in slots], dtype=np.int64)
        dofs = np.array([d for _, d in slots], dtype=np.int64)
        ids = np.array([last[s] for s in slots], dtype=np.int64)
        return blocks, dofs, ids
