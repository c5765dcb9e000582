"""slot_occupancy.batch: Mean over the window's decode steps of active slots / n_slots, in %:
the graphed step computes every slot's row, so this is useful rows over
rows computed (program counter: the engine's active slots)."""

def read(run):
    spans = run.spans_in_window("decode")
    return 100.0 * sum(s.rows / s.computed for s in spans) / len(spans) if spans else None
