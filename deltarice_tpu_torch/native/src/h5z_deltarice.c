/* HDF5 filter adapter for the native Delta-Rice codec (filter ID 32025).
 *
 * Role-parity with the reference's H5Z callback + plugin shim + dynamic
 * symbol loader (/root/reference/src/deltaRice.c:468-501,
 * deltaRice_h5plugin.c, hdf5_dl.c), implemented fresh:
 *
 * - The minimal HDF5 ABI surface (H5Z_class2_t layout, H5Zregister) is
 *   declared locally, so no HDF5 development headers are needed at build
 *   time.
 * - H5Zregister is resolved at runtime: first from the process image
 *   (covers any app that linked libhdf5, and HDF5's own plugin loader),
 *   else from an explicitly named libhdf5 (dr_h5_init_from), which the
 *   Python side points at h5py's bundled libhdf5.
 */

#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "dr_codec.h"

/* --- minimal HDF5 ABI declarations (stable since HDF5 1.8) ----------- */

typedef int herr_t;
typedef long long hid_t;
typedef size_t (*H5Z_func_t)(unsigned flags, size_t cd_nelmts,
                             const unsigned cd_values[], size_t nbytes,
                             size_t *buf_size, void **buf);

typedef struct {
  int version;             /* H5Z_CLASS_T_VERS == 1 */
  int id;
  unsigned encoder_present;
  unsigned decoder_present;
  const char *name;
  void *can_apply;
  void *set_local;
  H5Z_func_t filter;
} dr_H5Z_class2_t;

#define DR_H5Z_CLASS_T_VERS 1
#define DR_H5Z_FLAG_REVERSE 0x0100
#define DR_H5PL_TYPE_FILTER 0

typedef herr_t (*H5Zregister_t)(const void *cls);
typedef herr_t (*H5open_t)(void);

static H5Zregister_t dr_H5Zregister = NULL;
static H5open_t dr_H5open = NULL;

/* --- the filter callback --------------------------------------------- */

static size_t dr_h5_filter(unsigned flags, size_t cd_nelmts,
                           const unsigned cd_values[], size_t nbytes,
                           size_t *buf_size, void **buf) {
  dr_config cfg;
  if (dr_config_parse(cd_nelmts, cd_values, &cfg) != 0) return 0;

  size_t out_bytes = 0;
  if (flags & DR_H5Z_FLAG_REVERSE) {
    int16_t *out = NULL;
    size_t out_n = 0;
    if (dr_decompress((const uint32_t *)*buf, nbytes / 4, &cfg, &out,
                      &out_n) != 0) {
      dr_config_free(&cfg);
      return 0;
    }
    free(*buf);
    *buf = out;
    *buf_size = out_bytes = out_n * 2;
  } else {
    if (nbytes % 2) {
      fprintf(stderr, "deltarice_tpu: odd byte count %zu\n", nbytes);
      dr_config_free(&cfg);
      return 0;
    }
    uint32_t *out = NULL;
    size_t out_words = 0;
    if (dr_compress((const int16_t *)*buf, nbytes / 2, &cfg, &out,
                    &out_words) != 0) {
      dr_config_free(&cfg);
      return 0;
    }
    free(*buf);
    *buf = out;
    *buf_size = out_bytes = out_words * 4;
  }
  dr_config_free(&cfg);
  return out_bytes;
}

static const dr_H5Z_class2_t DR_FILTER_CLASS = {
    DR_H5Z_CLASS_T_VERS,
    DR_FILTER_ID,
    1,
    1,
    "deltarice",
    NULL,
    NULL,
    dr_h5_filter,
};

/* --- registration ----------------------------------------------------- */

static int resolve_h5(void *handle) {
  dr_H5Zregister = (H5Zregister_t)dlsym(handle, "H5Zregister");
  dr_H5open = (H5open_t)dlsym(handle, "H5open");
  return dr_H5Zregister ? 0 : -1;
}

/* Resolve HDF5 entry points from an explicit shared library path
 * (e.g. h5py's bundled libhdf5). */
int dr_h5_init_from(const char *libhdf5_path) {
  void *h = dlopen(libhdf5_path, RTLD_LAZY | RTLD_GLOBAL);
  if (!h) {
    fprintf(stderr, "deltarice_tpu: dlopen(%s): %s\n", libhdf5_path,
            dlerror());
    return -1;
  }
  return resolve_h5(h);
}

/* Register the filter with whatever HDF5 is reachable. Returns >=0 ok. */
int deltarice_tpu_register(void) {
  if (!dr_H5Zregister && resolve_h5(RTLD_DEFAULT) != 0) {
    fprintf(stderr,
            "deltarice_tpu: H5Zregister not found in process; call "
            "dr_h5_init_from(<libhdf5 path>) first\n");
    return -1;
  }
  if (dr_H5open) dr_H5open();
  return dr_H5Zregister(&DR_FILTER_CLASS) < 0 ? -1 : 0;
}

/* --- HDF5 dynamic-plugin entry points (HDF5_PLUGIN_PATH loading) ------ */

int H5PLget_plugin_type(void) { return DR_H5PL_TYPE_FILTER; }

const void *H5PLget_plugin_info(void) { return &DR_FILTER_CLASS; }
