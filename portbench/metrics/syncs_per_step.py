"""Host-device syncs a step: every sync the card's sync debug mode
reports over the sync stretch (the program's tracer counts each against
the innermost open span; here they are summed), per step (host clock:
counted on the host)."""


def read(t):
    steps = t.get("syncs")
    if not steps:
        return None
    return sum(sum(s.values()) for s in steps) / len(steps)
