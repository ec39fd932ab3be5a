"""Mean host time of one ``scan_call``, from the call until it returns
(the program's enqueue of the call's work), over the untraced window."""


def read(run):
    if not run.call_s:
        return None
    return sum(run.call_s) / len(run.call_s) * 1e3
