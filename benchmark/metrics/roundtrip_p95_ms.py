"""95th percentile (nearest rank), over every object of the window, of its
compress call's wall plus its decompress call's wall, in ms."""

from harness import percentile


def samples(run):
    comp, dec = run.of("compress"), run.of("decompress")
    return [(c.t1 - c.t0 + d.t1 - d.t0) * 1e3 for c, d in zip(comp, dec)]


def value(run):
    s = samples(run)
    run.notes.append(f"roundtrip samples: {len(s)}")
    return percentile(s, 95)
