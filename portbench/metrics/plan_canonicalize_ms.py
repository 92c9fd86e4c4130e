"""plan_canonicalize_ms: the plan's canonical form, _canonicalize_plan
(inside dispatch_plan); seconds of the program's stage
`plan_canonicalize` inside the window, over all threads, per batch
handed over in the window, in ms. None where the program records no such
stage."""

from portbench.spans import stage_ms

STAGE = "plan_canonicalize"


def read(run):
    return stage_ms(run, STAGE)
