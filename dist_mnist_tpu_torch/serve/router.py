"""Request classes and their decode SLOs (the constants of the reference
`serve/router.py`; the fleet router itself joins with the fleet slice).

Kept beside each other, as in the reference, so the router and the
decode scheduler can never disagree about what a class means.
"""

from __future__ import annotations

LATENCY_SENSITIVE = "latency_sensitive"
BEST_EFFORT = "best_effort"
REQUEST_CLASSES = (LATENCY_SENSITIVE, BEST_EFFORT)

#: What each request class optimizes for on the DECODE path
#: (serve/decode.py): latency_sensitive requests jump the admission queue
#: to minimize time-to-first-token, best_effort requests ride the
#: in-flight batch for per-token throughput.
DECODE_SLO_TARGETS = {
    LATENCY_SENSITIVE: "ttft_ms",
    BEST_EFFORT: "tokens_per_s",
}
