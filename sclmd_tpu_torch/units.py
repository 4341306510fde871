"""Natural-unit system of the semiclassical GLE engine.

The same constants as ``sclmd_tpu.units`` (kept as a copy so the port
never imports the JAX package). The MD stack works in natural units:
energies in eV, hbar = 1, one unit of time t0 = hbar/eV = 0.658... fs,
and mass-weighted coordinates scaled by ``MD2ANG`` angstrom * sqrt(amu)
so the dynamical matrix carries units of eV^2. ``RPC`` is the reduced
Planck constant in eV*ps used by the NEGF stack.
"""

from __future__ import annotations

# --- natural units (MD stack) -------------------------------------------------
TIME_SI = 0.658211814201041e-15  # one time unit, in seconds (= hbar / eV)
HBAR = 1.0                       # hbar in natural units
KB = 0.000086173423              # Boltzmann constant, eV / K
MD2ANG = 0.06466                 # mass-weighted coordinate -> angstrom * sqrt(amu)
LENGTH = MD2ANG                  # length unit in angstrom (mass-weighted)
CURCOF = 243414.0                # eV per time-unit -> nW  (1 eV/t0 = 2.43414e5 nW)

# --- eV*ps units (NEGF stack) -------------------------------------------------
RPC = 6.582119569e-4             # reduced Planck constant, eV * ps
BOLTZ_EV = 8.617333262e-5        # Boltzmann constant, eV / K

# lowercase aliases matching the reference's sclmd.units attribute names
# (units.py:5-10) so user scripts written against the reference port directly.
time = TIME_SI
hbar = HBAR
kb = KB
ohbar = MD2ANG
length = LENGTH
curcof = CURCOF

# --- element data -------------------------------------------------------------
# (symbol, atomic number, standard atomic mass / amu); public reference data.
_ELEMENTS = [
    ("H", 1, 1.00794), ("He", 2, 4.002602), ("Li", 3, 6.941),
    ("Be", 4, 9.012182), ("B", 5, 10.811), ("C", 6, 12.0107),
    ("N", 7, 14.0067), ("O", 8, 15.9994), ("F", 9, 18.9984032),
    ("Ne", 10, 20.1791), ("Na", 11, 22.98976928), ("Mg", 12, 24.3050),
    ("Al", 13, 26.9815386), ("Si", 14, 28.0855), ("P", 15, 30.973762),
    ("S", 16, 32.065), ("Cl", 17, 35.453), ("Ar", 18, 39.948),
    ("K", 19, 39.0983), ("Ca", 20, 40.078), ("Sc", 21, 44.955912),
    ("Ti", 22, 47.867), ("V", 23, 50.9415), ("Cr", 24, 51.9961),
    ("Mn", 25, 54.938045), ("Fe", 26, 55.845), ("Co", 27, 58.933195),
    ("Ni", 28, 58.6934), ("Cu", 29, 63.546), ("Zn", 30, 65.38),
    ("Ga", 31, 69.723), ("Ge", 32, 72.64), ("As", 33, 74.92160),
    ("Se", 34, 78.96), ("Br", 35, 79.904), ("Kr", 36, 83.798),
    ("Rb", 37, 85.4678), ("Sr", 38, 87.62), ("Y", 39, 88.90585),
    ("Zr", 40, 91.224), ("Nb", 41, 92.90638), ("Mo", 42, 95.96),
    ("Tc", 43, 98.0), ("Ru", 44, 101.07), ("Rh", 45, 102.90550),
    ("Pd", 46, 106.42), ("Ag", 47, 107.8682), ("Cd", 48, 112.411),
    ("In", 49, 114.818), ("Sn", 50, 118.710), ("Sb", 51, 121.760),
    ("Te", 52, 127.60), ("I", 53, 126.90447), ("Xe", 54, 131.293),
    ("Cs", 55, 132.9054519), ("Ba", 56, 137.327), ("La", 57, 138.90547),
    ("Ce", 58, 140.116), ("Pr", 59, 140.90765), ("Nd", 60, 144.242),
    ("Pm", 61, 145.0), ("Sm", 62, 150.36), ("Eu", 63, 151.964),
    ("Gd", 64, 157.25), ("Tb", 65, 158.92535), ("Dy", 66, 162.500),
    ("Ho", 67, 164.93032), ("Er", 68, 167.259), ("Tm", 69, 168.93421),
    ("Yb", 70, 173.054), ("Lu", 71, 174.9668), ("Hf", 72, 178.49),
    ("Ta", 73, 180.94788), ("W", 74, 183.84), ("Re", 75, 186.207),
    ("Os", 76, 190.23), ("Ir", 77, 192.217), ("Pt", 78, 195.084),
    ("Au", 79, 196.966569), ("Hg", 80, 200.59), ("Tl", 81, 204.3833),
    ("Pb", 82, 207.2), ("Bi", 83, 208.98040), ("Po", 84, 209.0),
    ("At", 85, 210.0), ("Rn", 86, 222.0), ("Fr", 87, 223.0),
    ("Ra", 88, 226.0), ("Ac", 89, 227.0), ("Th", 90, 232.03806),
    ("Pa", 91, 231.03586), ("U", 92, 238.02891), ("Np", 93, 237.0),
    ("Pu", 94, 244.0), ("Am", 95, 243.0), ("Cm", 96, 247.0),
    ("Bk", 97, 247.0), ("Cf", 98, 251.0), ("Es", 99, 252.0),
    ("Fm", 100, 257.0), ("Md", 101, 258.0), ("No", 102, 259.0),
    ("Lr", 103, 262.0), ("Rf", 104, 265.0), ("Db", 105, 268.0),
    ("Sg", 106, 271.0), ("Bh", 107, 272.0), ("Hs", 108, 270.0),
    ("Mt", 109, 276.0), ("Ds", 110, 281.0), ("Rg", 111, 280.0),
    ("Cn", 112, 285.0),
]

# synthetic / coarse-grained species used by reference example inputs
# (units.py:44-45): Cn = n carbon masses, Aun = Au mass / 2^(n-1).
_SYNTHETIC = [
    ("C1", 24.0214), ("C2", 48.0428), ("C3", 96.0856), ("C4", 192.1712),
    ("Au1", 98.4832845), ("Au2", 49.24164225),
    ("Au3", 24.620821125), ("Au4", 12.3104105625),
    ("D", 2.014),
]

AtomicMassTable = {sym: mass for sym, _z, mass in _ELEMENTS}
AtomicMassTable.update(dict(_SYNTHETIC))

PeriodicTable = {}
for sym, z, _mass in _ELEMENTS:
    PeriodicTable[sym] = z
    PeriodicTable[z] = sym
PeriodicTable["D"] = 1001
PeriodicTable[1001] = "D"


def get_atomname(mass: float, tol: float = 0.01) -> str | None:
    """Element symbol whose standard mass is within ``tol`` of ``mass``.

    Mirrors sclmd.tools.get_atomname (tools.py:218-226).
    """
    for sym, m in AtomicMassTable.items():
        if abs(m - mass) < tol:
            return sym
    return None


def get_atommass(name: str) -> float | None:
    """Standard atomic mass of element ``name`` (tools.py:229-237)."""
    return AtomicMassTable.get(name)
