"""Reports over what the port's runs record (the counterpart of the JAX
package's ``repro/analysis``; :mod:`.telemetry_report` so far)."""
