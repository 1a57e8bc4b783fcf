"""All samples the window evaluated over the window's seconds (host clock,
ended by a synchronisation)."""


def read(facts):
    samples = facts.window.get("samples")
    return samples / facts.window["window_s"] if samples else None
