"""History guidance: host planner and device-side prepare/compose."""
