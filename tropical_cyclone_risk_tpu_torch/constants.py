"""Physical constants (copy of tropical_cyclone_risk_tpu/constants.py).

The constant set of the reference model (util/constants.py:7-19), so the
thermodynamics are bit-comparable with the JAX package.
"""

earth_R = 6.3781e6   # mean radius of the earth (m)
T_trip = 273.16      # temperature at the triple point (K)
e_trip = 611.65      # vapor pressure at the triple point (Pa)
Rd = 287.04          # gas constant for dry air (J/kg/K)
Rv = 461.5           # gas constant for water vapor (J/kg/K)
cv = 718             # specific heat of dry air at constant volume (J/kg/K)
cp = cv + Rd         # specific heat of dry air at constant pressure (J/kg/K)
cpv = 1870           # specific heat of water vapor at constant pressure (J/kg/K)
cl = 4190            # specific heat of liquid water (J/kg/K)
eps = Rd / Rv        # ratio of dry-air and water-vapor gas constants (-)
Lv = 2.5e6           # latent heat of vaporization (J/kg)
L0 = 2.555e6         # constant latent heat for pseudoadiabatic computations (J/kg, Bryan 2008)
C_to_K = 273.15      # additive factor to convert Celsius to Kelvin
