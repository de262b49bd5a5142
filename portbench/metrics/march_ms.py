"""Host ms a step spends inside the program's ``sphere_march`` (every
call: the keypoints' and the render's), over the traced window's steps
before the profiled stretches. The march reads a count back from the
device every trip, so the span is its time (host clock)."""


def read(t):
    steps = t["march"]
    if not steps or not any(steps):
        return None
    return sum(s for calls in steps for s, _, _ in calls) / len(steps) * 1e3
