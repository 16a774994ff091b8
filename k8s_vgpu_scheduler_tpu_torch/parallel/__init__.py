"""Single-device attention references (multi-device families come later)."""
