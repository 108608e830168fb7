"""itl_p99_ms: the 99th percentile of every gap between two successive
token deliveries of a request, over all requests, the later delivery in
the window; a gap that a prefill stalled counts as it is. Every
admission stalls the other slots for its prefill, and in these mixes
2-5% of gaps are such stalls, so the 99th percentile lies among them
(where a 95th would fall on the edge between stalls and plain rounds
and swing between the two). Host clock."""
from harness import stats

UNIT = "ms"


def read(run):
    w0, w1 = run.window
    return stats.percentile(run.ledger.gaps_in(w0, w1), 99)
