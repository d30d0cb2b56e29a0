"""Operations the algorithm needs, counted from a configuration's shapes: one
file a kernel or model part (``fetch``, ``mlp``, ``embedding``, ``dwt``,
``adam``) and ``model``, which adds them up for a training step, a voxel of
the evaluation and a query point.  Recomputed work is not counted."""
