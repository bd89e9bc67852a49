"""Tiny sizes at which every driver runs end to end on the CPU in
seconds: the same code paths as the cells, with batches of 4, 64-pixel
crops and trees of 8 frames."""

TINY = {
    "contact_train_step": {"batch": 4, "res": 64, "tree_samples": 8, "tree_image_size": 128,
                           "pool_batches": 4, "threads": 2, "warmup_steps": 4},
    "hand_object_batch_b256": {"batch": 4, "crop": 64, "pool_batches": 2, "warmup_batches": 2,
                               "checked_calls": 2, "model_override": {"image_size": 64}},
}
SEED = 2**31 + 12345  # beyond 32 signed bits, as the benchmark's seeds may be
SECONDS = 1.0


def run_tiny(cell: str, seed: int = SEED, trace: bool = False, **extra):
    from portbench.run import run_cell

    overrides = dict(TINY[cell])
    overrides.update(extra)
    return run_cell(cell, seed, SECONDS, trace, device="cpu", overrides=overrides)
