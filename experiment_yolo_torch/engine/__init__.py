"""The predict and train entry points, and the predict results."""
