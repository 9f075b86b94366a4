"""syncs_per_step.<cell kind>: the host's stream syncs a step (or view):
the cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize
and blocking cudaMemcpy calls inside the traffic's per-step spans
(``bench.batch``, ``bench.step``, ``bench.render``, ``bench.to_host``),
over the steps or views traced (harness/spans.py)."""
from benchmark.harness import spans


def read(ctx, out, meta):
    at = spans.of(ctx)
    n = spans.per(out, "steps") or spans.per(out, "views")
    if at is None or n is None:
        return None
    return len(at.step_syncs()) / n
