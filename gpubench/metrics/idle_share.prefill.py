"""% of the calls' own spans (each call's first device operation to its
last) in which no device operation ran: the idle time of serving a
request, not the wait for the next one to arrive."""

from gpubench.readers import idle_share_calls


def read(run):
    return idle_share_calls(run)
