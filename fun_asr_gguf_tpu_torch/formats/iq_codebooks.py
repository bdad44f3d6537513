"""ggml i-quant lattice codebooks (format constants).

The IQ1/IQ2/IQ3 GGUF tensor types index into fixed codebooks of lattice
points defined by the ggml format (``ggml-quants.c``: ``iq1s_grid``,
``iq2xxs_grid``, ``iq2xs_grid``, ``iq2s_grid``, ``iq3xxs_grid``,
``iq3s_grid``; mirrored by the reference's vendored
``fun_asr_gguf/gguf/quants.py:707-1235``).  Like any codebook, the tables
below are part of the on-disk format spec — every decoder must reproduce
them byte-for-byte — so they are stored here as data: each grid entry is a
small-integer level index, two indices per byte, zlib-compressed and
base64-armored.  All decoding logic is original.

The 128-entry sign codebook ("ksigns") is not stored: entry ``i`` is just
``i`` with bit 7 set to the odd-parity of ``i`` (the eighth sign makes the
total number of negative signs even), so it is derived at import time.
"""

import base64
import zlib

import numpy as np


def _unpack_grid(b64: str, shape, levels) -> np.ndarray:
    """Decode a base64(zlib(nibble-packed level indices)) grid table.

    Returns float32 [n_points, point_dim] codebook values.
    """
    packed = np.frombuffer(zlib.decompress(base64.b64decode(b64)), np.uint8)
    idx = np.stack([packed >> 4, packed & 0x0F], axis=1).reshape(-1)
    lv = np.asarray(levels, dtype=np.float32)
    return lv[idx].reshape(shape)


def _make_ksigns() -> np.ndarray:
    """[128] uint8 sign bytes: bits 0-6 echo the index, bit 7 = parity."""
    i = np.arange(128, dtype=np.uint16)
    parity = i ^ (i >> 4)
    parity = parity ^ (parity >> 2)
    parity = (parity ^ (parity >> 1)) & 1
    return (i | (parity << 7)).astype(np.uint8)


KSIGNS = _make_ksigns()

_IQ2_XXS_SHAPE = (256, 8)
_IQ2_XXS_LEVELS = (8, 25, 43)
_IQ2_XXS_B64 = (
    "eNpNk4uNAzEIRA0VABVg91/kvYEkOq0m6zgGM5+cc06DBA4eiDjHYn9o4OCBMPZtDzuIy/"
    "e7hQ2e3jQIHgNqlJ9m5nG8tuk8NG4a66QeNY9m1XtJA9dll31nH5zi/XaABq5BOjmSp+4O"
    "FcX63N9w5uDtkKrQY8EnA4exBiedNuw536k+VvR/nHvDwpZSRH+I3SkNjkbWEnWR7SX8RN"
    "ojrDvSegTQrZCKBGWsnb3I6Jv8fkOPimDNTT6ChfM+FTCK8yoi3wjYK7Mkamg2lBo6XR1N"
    "23FNCseoaUwNzLiK98kOY4qbjWgtJWSEFbA3w8qBs5apm6n6rAWUsbpLyFauNY+uUND4lk"
    "BkZajbXIUNa6z/M7cQQgpZ5xgd47j/DM+P6Z5F77L2Yo8A1IZAzklx1PkFAgtpNjJzFIGL"
    "gFDW4J1EbFTIDQsCU+tpl+BY0e/NIOMwLInOBImq6zh1bk+oUsGKvMx+Ge6K3dm/iePLmC"
    "hhRUQuSi3CM6aKmNKT3/DdDSAZdo1AdtkH99LPOV/UvhFCicMLKV5Es0hMcVth64S2cdGQ"
    "NVK0aNVV+uuizBM5Gig2jwHZ8xHyDw/ZKOM="
)

_IQ2_XS_SHAPE = (512, 8)
_IQ2_XS_LEVELS = (8, 25, 43)
_IQ2_XS_B64 = (
    "eNpVlQuS5DAIQ2NOAD4BcP9D7hMk07XtUk0+jm2EpHme50kQwEAD9+c5oMD1nZAggAE/vA"
    "cF7tmPEwQw4MX72gUTBDDgl+fg3t3IGQcUuEAbJwhgoIEnc3IPlCCAAQ+exx7SgBv39juw"
    "RgAD7snnW4Qfrs8WE29BDXQSjQIXqMgEAQx48ja38AQBDHjwHFQsIW7c248YnULDgHtwji"
    "XLD9dnSfNa4nx2ryGwcklMcGzJzFnFZjRwN9ZbkgP44f4s4faR3swFPlXdvya43efa24hk"
    "NVCX6+7pxNk2arbapDaIctEsOkXjNC+XApWt8lTWNLRrjqcj/TU3d4oez+/4NlwX5/waf6"
    "573X2pLsDCTwi1Yshh8gwDWkBDAtFCB9yzYjm1gvHpZPwnnOPFvJpN1WVVl6+QTpiXraAC"
    "lA4U7bd7BJYreck7xaCvPEd4vhL5CbC3ANH1iZEjZdSKUj8akNY5RUppYvjmT6wcKBPB3h"
    "tDQjsK6RoB23QPEacxhXtjMURtdROz8b5517OBgQa+FpZNZUnZUOyKGdloCNbuz8peEpes"
    "T58lXvKVXKO2CZLeZ5xcGaj10xx1Raz4tubPVFB8KGQaJ8pEUYKbP7PlbjXK9v0ceawJda"
    "vfZ8bzNl0PpMqTa86+a04UziRMGisKffQZNgAHOllrXpeCWPCJe25x/fQYOjfm5C6pVXE0"
    "Jof9EZg2/wzva40xfrzmzzcAdLjuHDHqkKKM0pfZ4pojeW9AmLY0/gLPCqvi3YYG5LMv4R"
    "EW95oUyhqIBIT1CF3Ff+Gi1YmWKhu7T9icREpUjuAmdHAG82O6G+B0TMp2WaHAqqdZp0eA"
    "z/5LUOwrbRTbiucJK1Q3xhLRX3BJrIZYiZkxnBrAZn9hhj3txhtqOdKe8ax0x5xqmOSVKv"
    "wLvTp2bcNPjYyGLhzcqpQttW1oiZjLMYm1sfcdszy6AZDCnx7jSwhfcML2ZfUJUFyq2Lgi"
    "g68nUEW6BIMC6MLBdUHAxk0AnYSI3Wq7qIny+j7VE745Ca3UVUrwV2nBcE1Sl9snoGVgCO"
    "H9G9bYmLobedIdrVyilDVsjE6BzLEZHL9hh/ZRHEvw6QSZfv8Acs1cLg=="
)

_IQ2_S_SHAPE = (1024, 8)
_IQ2_S_LEVELS = (8, 25, 43)
_IQ2_S_B64 = (
    "eNpVVwmWKzkIM5wAfALw/Q85WtLJn9TT606qygsIIZ9zzgANJPCAqnMCWOCWHxiggQQqcB"
    "9Y4IZfHqCBBGpxH1jgrgceoIEE6uL+9WQNPKBwBbDABbiIARpIoAb3xwsboIEEqvE7sMBt"
    "L7qBBCpxL72JARqoh9+eN8WrgQSqBkN7ow+owHdggRvefH8C0MAD4mKEN1o5rwUuwAAN0E"
    "ACNbgLLHDHwRuggQQeUI1ngAVuO7gDNFCJe8ACNx30BhKoh3vPSeBueCXwgKrGnhohaYTA"
    "SWoggQrcAxa44eQN0EACtbi/TugADSRQF78D57WyxV3zugAT35/kN5BANZ5pk6ES/+ePFK"
    "OVpq6qxFoTa02s1YRp4AEVuAcscMNEGqCBBGpxf02uBuLivZdiEjNCwg3QQAI1JmADCVTj"
    "OeAs/k/8vSZn1cOaHijxELOHtZiw9z4xNEx10pn0JUVJR9KOdCKFak0PUoApZiqZFoafIW"
    "Y4RfpxqBgihoJb5rZUDO1lcTkVnprDcxg+yp/1CWCBWy6eARrI8c0AFrjhwhqggWy/GOti"
    "G6CBTA8WnwFDURzttMsTxLgwOzxZfCYMAGRXwY5YGMowF8JrgVsu5gZyvMAAFrjhIh+ggW"
    "wvPtaFP0ADmd5QACgkbSzEwlbGj1baurK86RiLxgANZDgQ0RYSBiTyJygtVq6CxJWjMBWs"
    "iJ/YvOfgseJXLEsxgbPyYlApRgM0kOEgB4DCVrAjLVajar2qhFKULGBMRISF7C6ee/h+3l"
    "fUti1sYzmm5FJCKZezlkCJXlu2lFBKEaVjXP6DkpUgonwGpTHQZiWcFD6mFGkzvJjacYpE"
    "CIYUYZryNkdbUfWMPglAWzEnltj4jh+go5PPJKJKQiFQnaHqYaYQFcwUuijIfBm6ifSbdN"
    "BMiTQCijl/Yt1SjxYpyTDumuSE5knId/E38ZtUeV2psXN7JfJUyRIrTWboj4T/YdHQFpGb"
    "ao4Knr5X6sDdxUKxsKEHlNskWyHbHdsbWxjbFdsS25CKIzSzm8i4DVDuKesqnLAUU3bVZM"
    "aSqoKiNB7LV0AjKFcBjVATGssMpUSFFy5xlrMa1LhcVZDh0mIZqXGNy4FloGIl3UnvMWVJ"
    "VRVwmIIqZNKJVBlTQWxnxo7TxPSo2JkGhr0cVjXE8Tal9NxCeUmqMk5zPJQyyNd4mx9oBd"
    "bsZkpiQCuwZosIb7LBkizQCqzZwsIX2HRLHbjVrdgNjlSspQqs0hoPesJE4wWtkCBxIjbr"
    "txYnTvrXuEddddWxSmrmZl7hRampJ555FrNQF0p1h5EapRSixos/YXJzdl4UPm6IhoCb+j"
    "MFo05+1SVLCgqDMBZHbvrPNOy1WDII/xqIsYWjTaPtosWiutE2yVyMLRDtj0Q2vBOOKuMx"
    "tg+0ChJgBva4jbNVszVLlOMjzOGWx/YmszJuR2w9Em0m47g9sAVQ7iXkTBBluSylX3PTcg"
    "WSJyWPqlaWC63urs1PucTkTFg6x2WgDkB6l+mqyhtTShEvU0CmqZyOr3kab12upLxcKWr5"
    "9a+xKjm8Vfff+ZmsketKOZpSt7PxqjC5GNX3MWElot3/mbFbD5PjiffUtML2m3Z6x/Z42W"
    "nKllbGrW0p1eC4K14k7Z+ZG1sU2hA1P5IZuqEmSFIry2h395rgcjEhaUVDHBnBljOT7KgA"
    "2GHKZfs1iWUafc3iA5LhuTaOcVdNlkVDh8S7eW0k3yCrqEI24OPjCY8gPGbw2MAjQoK/Mp"
    "sMctlyy3iOrS5trZr2sZ1U845PAw9bLxnUsVWiLcoaF+uxdVHCaEfKdkJNn0XMNn6fDS0T"
    "il4oM8DiLrcxVUhZ8uWQKeVHDkryK2dAOT2WPhGClV+WIxnjsjR8DfK4DOWIy6Uj01ym8t"
    "c8v7QBIRWY6js/M83QlLclxee0HJJNsCQ6V2a796qTg6FgIJojRmWTLB8P6aZ5pKMbpKO6"
    "fJlidXwcEpk5WLmayD6ZH+5Gl22yzFB8DBHFjWoCtsscUehk7GEfSIqj05laphZZbm2Xrq"
    "bcMr4HgL02VZSyv8NAXpWUDgULxYxd0kgCSkrsKE04CvjAgCFkBM59Ojy0j7WPQssjJfzW"
    "Kx/1eDTjUeLhAR0wmtViqyUTwWA+momf3aCdkMmjWOsUgDaJoD1ePJQgeA/lgzFSCeAb2M"
    "ZDRl96Kg7PYZ0cCAU//wFZjMKY"
)

_IQ3_XXS_SHAPE = (256, 4)
_IQ3_XXS_LEVELS = (4, 12, 20, 28, 36, 44, 52, 62)
_IQ3_XXS_B64 = (
    "eNoNzruCqjAUAMCcBEgbEtE2CbC0AVRaQNQWAaX1tW6LgH7/vfMFg5BEOXJRjN4II40ECl"
    "CGesSYYcAU46xhhPlswfaMMiSlzKUrsdRSyFRO0pMf2UtmBgNGmcZQE+dTXuWfPMv7nNVD"
    "7ddh3V4PVxiK4Tash+XAwACAAg4JEPBhBzPYgFzpui52tcuUUaCU4oqoSKFYxjgW8TN+xa"
    "yoC7vAp/L0PK1O9U2/rf9tiV0cY4w1vmOBA8y44TUHrjjnhG/5l1OOtNSufmustZ60pc+a"
    "JZAUCU2OSVtuStOMzaI5Nmw0423sRkaAKMJJQmxyIRFBQgoshKjEUzDf+OA3fuhHvpumKd"
    "nNu2iH2mur23NbPB6P7SOdnCm33lZrTdbG+ljHBQ6mwAqc4BUM626dV151qJpu3dGunmFW"
    "M5mVvbCpjbyrd/fOXhH6YRTKzWYD+2Q/7qO9PIuz/Vt+gk/pVM7TOTh8uVy+fw4/ZPvYVo"
    "f6El7Sl/nyr6E1HShQn4b0vrJWKuqiMELZKUszJ+PHxRH1si978vcPT85X8A=="
)

_IQ3_S_SHAPE = (512, 4)
_IQ3_S_LEVELS = (1, 3, 5, 7, 9, 11, 13, 15)
_IQ3_S_B64 = (
    "eNoNkbd2qzAAQFUoqyTArJJoq0SJV1EcrxTbWd2SrIBJ3u+//MA9594LAAEc9GAGEFAgQA"
    "1uAAEGRlAAC8TgBDYQgAo4IAUhOIJ/ABBCODEEEkoGgkhOVuKRiXRkRy4k+8MR3vOZQ675"
    "jTM+csxbHvMT33jAK+7yPVeKqkEhJZWnCvVQnbJVon5VqD4UMNoshpnGRMYypQmMa3hvet"
    "TL/t4Xvd+f+q3/6vf99Uqv+updk2t4BTOfzYxmOd/nYrbnw58QgRwaCCGFGg5wgQhK6MEW"
    "PuABfsIdzP6UCVX0SiGtKaOYFtSnNk2oS7//YggxiEUg0YhIWKIUZ+GITBBt9Kyh1prpVW"
    "Pdal+n2tWq7mtR17VXF3VcP2u7PtRkgIMe2ICHaAgGdGtu6627PW9kUQtcxMKWafGXdHEX"
    "gAhSqEczgkigGt0QQzlaEUYR8lGJTshGCfpFLtqjj79BnEGm2cIkG5nHWhazgBFp5CyZzC"
    "WWL+nLSv7IUB4lyHne5zSXeZN7eZHHuZ1/5aSZG9TkTdRMjd9kzUdjRjrK8TVaYzW6I7jz"
    "+3xn9/N9d+9Xut5XvJarvXJMscYDXrDEHi7whGPc4Q0H+A2HmHjK673aY17uWZ7jZd63By"
    "IRoSiK2siOSAGLumBFXqwFLvyiLLbiXOwL1dL21srWa5PWad9bMsFJTOMUTd30Oe2n28N/"
    "kJd6oZd8TS9gGUtYyGqs1Yos37It1+L+7FNf+9LH/uSXfuCffRKrGMZDzOIituKfOI3d2J"
    "S01CUqZemVUwk63jXdq7O6sOtP84md0pN+tk/nCbdhw1u5BRu3oV3b0rbszt7sxP6yjzYJ"
    "VNAHImBBFGQBSGiSJzh5JFXCq7mC1Vp1VVBdqn1FDuaADtHheRDn+zk4V+f4k/+YH/lDHe"
    "0MjucUjuOAHdqtu/edSNs0Ts9pmropeKvf2Jv1Nr6X7+k7uKhLe3Eu/Zf1RX/1L3CNO7vI"
    "le7DtdyDm7o8pGETluEpJJnJYHbLWIazIOP7aD/tqz059kd9REf7KD/iD/7tfYN//wGwDb"
    "Fo"
)

_IQ1_S_SHAPE = (2048, 8)
_IQ1_S_LEVELS = (-1, 0, 1)
_IQ1_S_B64 = (
    "eNotmYGh6zoIQ4MnMJ4Ae/8heyT19eu3dXJTggEJ8n3fN6DBAg/szfedAwMWeKCLY5xY4I"
    "K++aMBCzzQJxcZsMAD9W2uv7nu/gpccMADPawXa+CA4YcbPLAv54MLFujF2mENXNAvRuq1"
    "wAO9Y/SABR7oGuye74C6vN/c1IAFHtiH88A5udkBCzywd2F3YXdhL3dTha18xiEP1OUz2I"
    "d10C93zCe/rv6P4xZ44Eyc2ODJmY13QIEGF5yOkwc0WOCBvcBhDSzwwH78LWhwwdH3ffHx"
    "xdb7FdBmDWiwtHGXY+CCA3rx/XAuOCcbK6/q9UDvbPSABR7oWti9MJPPN0EwYIEH+iQoBi"
    "zwANbhz4N9B/t4n4NPWavj4Nmg9X45Bg7Yh8/gggP6JcjGlj2/eifoBizwQNfjeg9f8n75"
    "fhOUAxos8PT5JFAHLPAUtAlXhaZCbv9DSKGg7XdA9387/m7eHRfq9nQ7uoW9Y4IupT/d/8"
    "O++oAGa+dLgQOaJHlKlM4J5MQuQF7sC04niRoUfzwkU4NNQtXLxQpc0EOCceELDhgSrsEC"
    "D5APhAFrKz9e4IJ+42y93imin1eDBQ7YwzGAM7CXz2CBB3QDBcgP7OV8MCQ4ObIXqMXaSs"
    "IXaLAAubPfyc0XII/2AePs0Q7HIbJErwsOUNEY0GCB93dYAXIM2+K8AeQYH1kD5Bg+iFML"
    "kGf4gnVAkuwBBRos8MB3sgEFyEF8xfmAPHTRGkAeeoNUMchIfHhtrV4LPIBD8F8K3AByFF"
    "s5Dl5lc8lVTGMNHG02hbBAgwXI2/3ApTg+MIdjoB7HwPavUXVmOVAKXHCAimmDBZ4K6+Uc"
    "UOCCA3qxdlgD/VJ8xx4/3MNx4JG72E9EgAarEowFyGPsJ8vB6xTtBg+cxXmHvwUNFsCJpC"
    "nHhO/ZUzW8gyKwLzhAhX9AgwX4I2zmGCCvuS7fwTshiAlFiZJELyYMUUSHAlTqhzJO0H9D"
    "OSUBXCpNKpOSphI2lCWTjMpMp4yoZFDNncrKBqWiUmz4MqTCEM4KO4WSQsNJqS1nO+fqfR"
    "HeuOHGFbotEtY/62q2HdkhNP2D07CXtRon9wXwGtfjOwfhM2zl82HthAD1B3AZtrJGMSC7"
    "iDwqL4DPsJN3QA5jb/ni5C42431wKR69UkDIV+zk82PtpXor83TXRx4tvoNVKTTkG9fiWM"
    "dYcmzgsjkrhEweYSdrgBxyUYLLBh4beAx7Ieutm7vYe/mF66J1APkx300BIxemFhm1QvDv"
    "T/JjtlpmBVWHzx5cfsFh2Lpc/ArAYRYEciIchh8jDuRQ+Av/Le73uFBSmbDn+K4vRfNUHE"
    "7Mu4DCXfiNddArwgL+wncce6y9CI0xkz4z1jfZLFmmF/zlQnwBHIZ9ESXaTLgLs1g7ESna"
    "XLiLt2d1sSOdSjuCJKmJvKCcWSq4sEsaXL2HXim+fAdfaE80J1oTlYmaVEXrTzmiGVGM6E"
    "OUoXKvsq6ybaKolFqVVZVKfpPvBN1KeTKRVMoNoinBqLJB2tc/7VFGTimlkatkj0PXQdsJ"
    "E+6BEBLYQgwp3ITt/vlUJZaJbWyjglTISgvEN7aFuBT4cBO2cc6fyC6Aoyz0lBQtwfdCcE"
    "fvVpVtFSelsc2Cbca5roSqKO1s0E7uyg/rBR+xJ20BKZKUMeQI9hCN4PyJUwaSL+wRazcJ"
    "yQmEKuetECsnYxvnAHiI0OI7SbvAA1LW5BB7eH2zbQa4rqZ7cvOKYInYsWUc/wtaETZBh2"
    "0XUzhP3ykG8A++CpmjG+vJcYfPYL848T79LhGBM8k7fm+5KpCk3Pvi+nwH8A9mxeHwDpdh"
    "fUUgaAMuOAD+sWBAPxKTsACQ4OZErn/ManuyWaoOnz3MeX+BMZ1NJD+5F7IVwEfcD2uAXM"
    "Vs3hEicJOLHLzE73PtvzDBudwXx/WuQODq17+AiqcYwkXEJOuXtZtA6UdGpHXqf8ukFklt"
    "j9octTBqWRxMakG+tBUtD+20CGoJ1AJI8ku+S6pLbkteSypTXvi7SGBJXMlZdxTLatry08"
    "KpIiGlJKAdS0axneRg/yWgZJ8FVkW+OQrkwS+Sy8W+IqEklySNJIMkeSzIKrJFEkVSRNJD"
    "MsNCrSIJJAFE+W6GROPvRcSJdid0aYbfoTlRlOhIdGMLKpQiKhF1iBJEBa0S/qUkqwzzGy"
    "6zScCUPwvDSmlSOcI0l53eKSlmAkqIK1ilTKg0OHrYUe/IThorZZWeSsf+p53F5iSNlDZK"
    "FaWFUkFhrTBWuLoAdEJPYcbesZYwUsi4C56EQv+33Z3Rly00uVa2wUrxxJUWuRX32CVyxZ"
    "fbddWsmO2sXjHBEbbzJ74r/aMWcV8cB+/flEo0q0jpIDWJOOQ4eDq2Urz0R3A795kmViJb"
    "BU0XokYRq3z8C+96uThcT8ym4aVecd94FVx3lmSr1t1JxIhlVZnmeFsBqThyDKAA2EOOT0"
    "R9u3Kx5qyHSSsN9e6IkerckF7obMzknH8joMKrG0VbWLTohtEX7CNrgLrnZkFOQG8gYOIM"
    "ah8ylHOe7kOOWO66z7fcMbZVdxoMWNuOW64eaTaq40hZpNcB6HNuj2Og9RkCOOCTkDpx+j"
    "ppUs6/URlPEY474O0uLBtyrciPVZnYuSqbdF0VM1zYHWFWnc27tuL49f6Nj0hHm0rtxAWs"
    "rWww9dNNkQhJm00NZZl1fRdB0SiheRwET8MLVCbOY++48iQwYAxsSTPV3hHW/MsRhwqaBR"
    "7YkB1ayIJRgYT25/dYA/slsCpjJI2NHGCwucYyGrWwu/KuRydu1ipjkXvUuBGAVwH4+IwQ"
    "LU9N3NpTMt2Oq822QL1pnR2o1Ew3fZ2WUt5RK3fVrqF/TMK0VBa1CuadFkZti5vDm5YAdW"
    "apLgnuAL+OAtb/gb4jMyURJc0sjttdIiy001xeq9EMgiayx4z7/k1nRXo44rWr1DF7YUL7"
    "FgQdKhb1WnxXaPT+KfP+KVF0yD0kyVboyM1shxLcAVbKppWESuCXEuaK2Sktjqyd1PWLRf"
    "aDd9KCMMd3aYo74acQwwaHkBOYm7jrpUE4n7cAeuEyYMVlVr9t1cHp/8a68vP3/1O6jKNB"
    "S0tRwf+oBfiDYxJBFAcMwwe8aZBGQ46Q4CD/6R2RRHfrAiL1O51CouhV437+BQW9wzVyUX"
    "KXODueJqnAqLEvdzjHHYWGdNuK8NgAqabdEWDtanWckZ89hhIBNFjsI58Biche8f2lcKFn"
    "2KPnacLazwq9rIYee5OitpxpEXbtK3I+RQ6Ng90cO7nhL+NijYM1/vUQcTJm1Th1qSB+GY"
    "WuylhTY0wXyC+jRY0PNS50wfwyztOoTqM5F1ANNiQsMVpTBI2yNJbS+EljJA8rp1Nob0Y3"
    "qkgarWhsggdSgM/yuMIbpBGExglfRgKeZKrFV5H+0na7M1T3tdPeqmXF7gxEJy2j2kTszo"
    "B00qapLVNrhK0Zwqgd2ZH6kukeypR3J+L4/Ac0knYTibU02bjuJCmdkS0mCsmKHSo3adxQ"
    "LNcNgdzQlejIwx5RzQ1VLGiBhjYEwx85KLenSWzpDuHslAql+CJHPOgVAZ2kl4dF15FwfW"
    "UNjp5C8mUgPNlOT1u1FV/c6A5b7tnuZJaHTRUzsJv3m0GyTtU/enETngbLasy1QD9uAqQo"
    "eVClpkGJJELclQbiWs0fq+XpECUsgt1pLuQJEhef8/llYD2eXj9Ph0Wo32QIsNxxs0bHs6"
    "3knlXAtzIgkFF6iYA17NbAQEbSk2OnH3kcJTebS7iFoNX93jw2MFmvjO81giejtEMek3ML"
    "HoVr/G1C337a4HHz0YT8y1jYjtAEbGfcS+JzfDJwlwD4MjJ109QZdWp8eSYjRjdS2sXJ2E"
    "5jOg/7KuO1w8U1IvPwrzKy0vjJjdfNaMgD/cnIx5uhwoUhjrbKSITrjJ/klJ84eMRgMaKN"
    "Uzv/pc1211BpiV3wVtpctbOEqFtXC5dK6+hBTKW988bDSfxWHi50Wia1R37QsNPaWOzctC"
    "SawFn4HE9WMsisyHsXWMn1L3LbXUZFIrvwrkhbq5AduWmGuq64rQrjbFMky7sTueXXjTyi"
    "FHP9yCALLQXr+w9P1bB+kRLYyudRYb+eLHXo2R2raHZCoSaA8xdpS7RHtJcjnrK/MqCq0I"
    "UbYJV2As9Pl27KoqdzO+XJ3eakxHDtZaVVKQeuIoqYm3TC/uUnYjdh6wc5k3Bjnx1K3EOG"
    "wJUQ8SRqssXu/LV9O263mLxxk4dpbca1ua7gqpz6qckp+JJ1/gc55UmZpvSTRl7kxw37YZ"
    "JEqZJfw2cqpQfQ5Z0IOX55/KnHm3oypEeTfvg0eXSoR4R6DKhHe3qcp8d0eiznh1OTR2F6"
    "9PW0s18eTbm46FGTnt7hGD210SMfTe2fJuFPn/M4RN2xxfKymvXjAz0iULVWJVAmaaT+dL"
    "eTUbWfZn2bm90ZKq6MfzXO5XrqVDxutej+Mgp1gVPVUvR9GUG64GmseLbHbR7Ea/DxuVst"
    "i/WVUZMH9G3145GQnSwhf/3EzmMIDzTbTxMQE2nP1W6rdfY0oNJuWnScv/Dniwf9apHUBN"
    "yVDZu0Ik+RJvm+I63xHZ89QbbEtWjBYR6gdkfASEKi61DNfIf5qK5cK8JGEYNHH5b79UW6"
    "uNC//wPECdV76ip6rlCsA+gLtZkQxADK4i/U4ZcoQWW+8qQDW4+bF0qfpzedlHc3cG+C8E"
    "uY+0HlJJz8pPLLtppstFXb0wO7zIppYoJZSJf9cpqt0L8f1NAgHw=="
)


GRID_IQ2_XXS = _unpack_grid(_IQ2_XXS_B64, _IQ2_XXS_SHAPE, _IQ2_XXS_LEVELS)
GRID_IQ2_XS = _unpack_grid(_IQ2_XS_B64, _IQ2_XS_SHAPE, _IQ2_XS_LEVELS)
GRID_IQ2_S = _unpack_grid(_IQ2_S_B64, _IQ2_S_SHAPE, _IQ2_S_LEVELS)
GRID_IQ3_XXS = _unpack_grid(_IQ3_XXS_B64, _IQ3_XXS_SHAPE, _IQ3_XXS_LEVELS)
GRID_IQ3_S = _unpack_grid(_IQ3_S_B64, _IQ3_S_SHAPE, _IQ3_S_LEVELS)
GRID_IQ1 = _unpack_grid(_IQ1_S_B64, _IQ1_S_SHAPE, _IQ1_S_LEVELS)
