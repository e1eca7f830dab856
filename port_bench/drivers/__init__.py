"""One driver per traffic ``kind``: the window loop of that kind of work."""
