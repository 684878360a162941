"""Checkpoint store (torch port): ``store.save`` / ``restore`` /
``list_steps`` / ``latest_step`` in the reference's on-disk format."""
