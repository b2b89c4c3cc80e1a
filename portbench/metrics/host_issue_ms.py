"""Host ms a step inside the program's `model.step` call, the mean over the
untraced window: the Python and launch time the host spends issuing a step.
Where it nears the step's device time, the host sets the pace."""


def read(rec):
    if not rec.issue_s:
        return None
    return 1e3 * sum(rec.issue_s) / len(rec.issue_s)
