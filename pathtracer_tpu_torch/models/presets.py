"""Material presets (counterpart of pathtracer_tpu/models/presets.py): the
GUI preset menu (reference: mainApp.cpp:1499-1597).

Classic OpenGL material table (devernay.free.fr) and Ngan et al. Phong fits,
as (kd, ks, ne) triples ready for ObjectSpec / group-material assignment.
"""

PRESETS = {
    'gold': dict(kd=(0.75164, 0.60648, 0.22648),
                 ks=(0.628281, 0.555802, 0.366065),
                 ne=(51.2, 51.2, 51.2)),
    'gold_ngan': dict(kd=(0.069, 0.0323, 0.00638),
                      ks=(0.0738, 0.0434, 0.0104),
                      ne=(41.9, 41.9, 41.9)),
    'silver': dict(kd=(0.50754, 0.50754, 0.50754),
                   ks=(0.508273, 0.508273, 0.508273),
                   ne=(51.2, 51.2, 51.2)),
    'silver_ngan': dict(kd=(0.0695, 0.0628, 0.0446),
                        ks=(0.0742, 0.0615, 0.0412),
                        ne=(75.0, 75.0, 75.0)),
    'pearl': dict(kd=(1.0, 0.829, 0.829),
                  ks=(0.296648, 0.296648, 0.296648),
                  ne=(11.264, 11.264, 11.264)),
    'pearl_ngan': dict(kd=(0.189, 0.146, 0.0861),
                       ks=(0.0485, 0.0346, 0.0161),
                       ne=(27.7, 27.7, 27.7)),
    'white_plastic': dict(kd=(0.55, 0.55, 0.55),
                          ks=(0.70, 0.70, 0.70),
                          ne=(32.0, 32.0, 32.0)),
    'white_plastic_ngan': dict(kd=(0.102, 0.0887, 0.0573),
                               ks=(0.00699, 0.00566, 0.0036),
                               ne=(1040.0, 1040.0, 1040.0)),
    'chrome': dict(kd=(0.4, 0.4, 0.4),
                   ks=(0.774597, 0.774597, 0.774597),
                   ne=(76.8, 76.8, 76.8)),
    'chrome_ngan': dict(kd=(0.00817, 0.0063, 0.00474),
                        ks=(0.0213, 0.0151, 0.00766),
                        ne=(17900.0, 17900.0, 17900.0)),
    'bronze': dict(kd=(0.714, 0.4284, 0.18144),
                   ks=(0.393548, 0.271906, 0.166721),
                   ne=(25.6, 25.6, 25.6)),
    'bronze_ngan': dict(kd=(0.0864, 0.0597, 0.0302),
                        ks=(0.015, 0.00818, 0.00381),
                        ne=(1290.0, 1290.0, 1290.0)),
    'copper': dict(kd=(0.7038, 0.27048, 0.0828),
                   ks=(0.256777, 0.137622, 0.086014),
                   ne=(12.8, 12.8, 12.8)),
    'copper_ngan': dict(kd=(0.0749, 0.0414, 0.027),
                        ks=(0.0756, 0.0437, 0.0202),
                        ne=(33200.0, 33200.0, 33200.0)),
}


def preset(name: str) -> dict:
    """Material kwargs for ObjectSpec: sphere((...), 10, **preset('gold'))."""
    return dict(PRESETS[name])
