"""Pose-map expansion and weight conversion."""
