"""Plain versions, dispatch and Hopper kernel wrappers for the dual-component
TwinQuant linear."""
