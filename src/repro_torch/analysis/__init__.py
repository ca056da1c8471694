"""Per-device counts and roofline of the port's steps: counterpart of
src/repro/analysis (hlo_count, roofline, profile_tools, report)."""
