"""TH201 via the hot-module path match (this file's path ends with
``federation/scheduler.py``): host reads INSIDE for/while loops are
flagged without any decorator; the same read outside a loop is not."""


def drive(srv):
    out = []
    for rid in srv.queue:
        out.append(srv.fetch(rid).numpy())  # TH201: a read per iteration
    final = srv.buffer.cpu()  # quiet: one amortized fetch after
    return out, final
