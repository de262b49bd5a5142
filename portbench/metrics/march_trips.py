"""Trips a march makes: the program's ``march.trips`` over its
``march.calls`` (every march: the keypoints' and the render's) in the
span stretch (host clock: counted on the host from the count the march
reads every trip)."""


def read(t):
    counters = t.get("counters") or {}
    calls = sum(n for (_, name), n in counters.items() if name == "march.calls")
    if not calls:
        return None
    return sum(n for (_, name), n in counters.items() if name == "march.trips") / calls
