"""Points-in-rectangle filter: count and membership mask."""
