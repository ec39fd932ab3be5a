"""Mean host time from a block's hand-off (before its copy to the card)
until the program's ``__call__`` returns, over the untraced window."""


def read(run):
    if not run.handoff_s:
        return None
    return sum(run.handoff_s) / len(run.handoff_s) * 1e3
