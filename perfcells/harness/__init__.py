"""The benchmark's generic machinery: it finds configurations, cells,
entries and metric readers by name and holds no cell- or metric-specific
code."""
