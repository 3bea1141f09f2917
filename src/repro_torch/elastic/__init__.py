"""Elastic rescaling: ScalePlans executed as range copies over packed buffers."""
