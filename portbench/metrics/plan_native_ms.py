"""plan_native_ms: the forest planner itself, native or numpy (inside
dispatch_plan); seconds of the program's stage `plan_native` inside the
window, over all threads, per batch handed over in the window, in ms.
None where the program records no such stage."""

from portbench.spans import stage_ms

STAGE = "plan_native"


def read(run):
    return stage_ms(run, STAGE)
