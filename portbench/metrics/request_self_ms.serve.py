"""Request path: milliseconds per request that ``serve.request`` (the root
span of ``InferenceService.infer_root``) spends outside its child spans:
the host work no span names. Mean over every request the process served
(``program_trace``)."""

from portbench import program_trace


def read(ctx):
    recs = program_trace.records()
    if not recs:
        return None
    tops = program_trace.roots(recs, "serve.request")
    if not tops:
        return None
    children: dict = {r.id: [] for r in tops}
    for r in recs:
        if r.parent in children:
            children[r.parent].append((r.start_ns, r.end_ns))
    own = sum((r.end_ns - r.start_ns)
              - program_trace.covered([[r.start_ns, r.end_ns]],
                                      program_trace.union(children[r.id]))
              for r in tops)
    return own / len(tops) / 1e6
