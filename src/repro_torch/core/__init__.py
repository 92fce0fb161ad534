"""Topology, CommPlan, schedules and scenarios (numpy copies of the JAX
package's planners), the protocol formulas, the flat-parameter substrate
and the wavefront engine."""
