"""``host_updates_per_s.map``: map updates a second of the host's clock in a
traced run's window before the profiler started: the closed loop's rate,
paced by the host's launches and the field's host sync, which moves with
the host's speed from machine to machine (PERF.md §2)."""


def read(rc):
    if rc.untraced_steps <= 0 or rc.untraced_s <= 0:
        return None
    return rc.untraced_steps / rc.untraced_s
