"""Images of the window's finished steps over the window's seconds on the
host clock (one synchronisation at its end): the wall rate a user of the
trainer waits on, which the host's noise moves too much for a bound."""


def read(facts, run):
    return facts["images"] / facts["window_s"] if facts.get("window_s") else None
