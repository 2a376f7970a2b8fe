"""Launchers: the serve and train drivers, the meshes and shapes, and the
dry-run."""
