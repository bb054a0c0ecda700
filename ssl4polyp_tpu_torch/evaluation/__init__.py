"""Split evaluation over the port's forward."""
