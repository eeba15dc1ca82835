"""
Physical constants shared by the physics core.

A copy of ``ics_wt_physicsengine_tpu/core/constants.py``: the values must
stay identical, since the parity tests hold the port against the JAX package
bit for bit on the CPU. All constants are plain Python floats; the dtype is
decided by the tensors that flow through the formulas (float64 in the CPU
parity tests, float32 on the card).
"""

# --- Universal constants ---
R_GAS = 8.314                 # [J/(mol K)]
T_REFERENCE_K = 293.15        # [K]  (20 C)
T_REFERENCE_C = 20.0          # [C]
T_25C_K = 298.15              # [K]  (25 C)

# --- Chlorine decay Arrhenius parameters ---
CL_DECAY_K_REF = 1.0e-4       # [1/s] at 20 C (EPA)
CL_DECAY_EA = 45000.0         # [J/mol]

# --- Water ionization ---
DELTA_H_WATER = 55900.0       # [J/mol]
KW_25C = 1.0e-14              # [mol^2/L^2]

# --- Carbonate system ---
PKA1_25C = 6.35
PKA2_25C = 10.33
DPKA_DT = -0.008              # [pH/C]

# --- Diffusion ---
D_MOLECULAR_REF = 1.0e-9      # [m^2/s] at 20 C
VISCOSITY_EXP_COEFF = 1800.0  # water viscosity exponent

# --- Liquid-water temperature bounds ---
T_MIN_C = 0.0
T_MAX_C = 100.0

# --- Chlorine speciation ---
PKA_HOCL_25C = 7.5
DPKA_HOCL_DT = 0.01           # [pH/C]
K_OCL_RELATIVE = 0.02         # OCl- decays 50x slower than HOCl

# --- Transport ---
WATER_KINEMATIC_VISCOSITY = 1e-6   # [m^2/s] at 20 C
C_MIXING = 12.0                    # Corrsin mixing-time correlation constant
D_TURB_COEFF = 0.1                 # D_turb = 0.1 * N * D_imp^2

# --- Spatial / stratification ---
G_GRAVITY = 9.81                   # [m/s^2]
WATER_DENSITY_20C = 998.2          # [kg/m^3]
THERMAL_EXPANSION_COEFF = 2.1e-4   # [1/C]
DENSITY_ANOMALY_COEFF = 0.008      # [kg/(m^3 C^2)] parabolic fit near 4 C
RHO_MAX_4C = 999.97                # [kg/m^3] density maximum at 4 C
SALINITY_DENSITY_COEFF = 0.7       # [kg/m^3 per g/L TDS]
JET_PENETRATION_COEFF = 6.2        # z_jet = 6.2 * d * Fr

# --- Thermal properties ---
WATER_CP = 4184.0                  # [J/(kg K)]

# --- Chemistry unit conversions ---
ALK_MG_CACO3_PER_EQ = 50000.0      # mg/L as CaCO3 per eq/L
CACO3_MW = 100.09                  # [g/mol]

# --- Solutal expansion coefficients [m^3/kg] ---
SOLUTAL_EXPANSION = {
    "NaCl": 7.0e-4,
    "CaCO3": 2.0e-4,
    "Chlorine": 1.0e-5,
}
