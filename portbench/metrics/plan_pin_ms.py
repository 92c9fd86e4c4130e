"""plan_pin_ms: the pin of the plan's widths per workload, its lock
included (inside dispatch_plan); seconds of the program's stage
`plan_pin` inside the window, over all threads, per batch handed over in
the window, in ms. None where the program records no such stage."""

from portbench.spans import stage_ms

STAGE = "plan_pin"


def read(run):
    return stage_ms(run, STAGE)
