"""Host ms a step inside the program's ``optim.update`` span
(``guarded_update``: the finite checks, Adam's update and the moments'
sanitizing), less the spans inside it, over the span stretch (host
clock)."""
from portbench.harness.spans import self_s


def read(t):
    steps = t.get("spans")
    if not steps or not any(r[0] == "optim.update" for rows in steps for r in rows):
        return None
    return sum(self_s(rows, "optim.update") for rows in steps) / len(steps) * 1e3
