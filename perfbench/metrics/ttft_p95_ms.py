"""ttft_p95_ms: the 95th percentile, over every request completed in the
window, of the time from its client's sending it to its first token on
the host (linear interpolation between order statistics)."""
import statistics


def read(rec):
    if rec.kind != "serve" or not rec.batches:
        return None
    ttft = [b["t_first"] - b["t_send"] for b in rec.batches
            for _ in range(b["rows"])]
    if len(ttft) < 2:
        return 1e3 * ttft[0]
    return 1e3 * statistics.quantiles(ttft, n=100, method="inclusive")[94]
