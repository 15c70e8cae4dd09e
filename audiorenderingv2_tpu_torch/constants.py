"""[Copy of audiorenderingv2_tpu/constants.py: numpy only, kept equal to it by tests/test_torch_host.py.]

Physical and numerical constants of the acoustic renderer.

Values mirror the reference engine's hard-coded constants
(reference: prebuild/obj_raytracer/devicePrograms.cu:13-15, 93-94, 125, 207-208)
so that IRs produced by this framework are statistically comparable.
"""

# Speed of sound in air [m/s] (reference: devicePrograms.cu:13)
SPEED_OF_SOUND = 343.0

# Volume of the unit receiver sphere, 4/3*pi*r^3 with r=1
# (reference: devicePrograms.cu:207-208 — per-ray energy is
# base_power / (n_rays * SPHERE_VOLUME))
SPHERE_VOLUME = 4.18879020478

# Receiver sphere radius [m] (reference: devicePrograms.cu:93-94)
RECEIVER_RADIUS = 1.0

# Time for sound to cross the average head breadth of 15.5 cm [s]
# (reference: devicePrograms.cu:124-125). The cross-ear delay in samples is
# int(sample_rate * HEAD_DELAY_SECONDS) — C truncation, not rounding.
HEAD_DELAY_SECONDS = 0.00044

# Absorption applied by the head to the signal reaching the far ear
# (reference: devicePrograms.cu:15; configurable via hrtf_absorption_rate)
DEFAULT_HRTF_ABSORPTION = 0.9

# Absorption assigned to scene materials not matched in the config's material
# table (reference: AudioRenderer.cpp:47-55)
DEFAULT_MATERIAL_ABSORPTION = 0.5

# Offset applied along the outgoing direction after each bounce to avoid
# self-intersection (reference: devicePrograms.cu:179)
BOUNCE_EPSILON = 1e-3

# Minimum parametric distance for a hit to count (self-hit guard for the
# analytic tests; the reference relies on the epsilon offset alone).
T_MIN = 1e-4

# IR length clamp in seconds (reference: devicePrograms.cu:227)
IR_SECONDS_MIN = 1
IR_SECONDS_MAX = 999

# TPU lane width — fine axis of the factored (coarse, fine) IR histogram.
HISTOGRAM_FINE = 128
