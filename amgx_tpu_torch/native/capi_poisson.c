/* capi_poisson.c — a C host code of the port's C API.
 *
 * Assembles the 7-point Poisson matrix of an n x n x n grid in CSR, as
 * a host code would (rows in lexicographic order, the first coordinate
 * slowest; columns in increasing order; 6 on the diagonal, -1 to each
 * neighbour), with b = 1, and solves it through the AMGX_* entry points
 * of amgx_tpu_torch_c.h: upload_all, a print callback that counts the
 * lines it receives, setup, solve from x = 0 and download.  It then
 * computes its own relative residual ||b - A x|| / ||b|| in double,
 * writes x (n^3 values of the mode's vector type) to a file, checks that
 * a bad handle returns AMGX_RC_BAD_PARAMETERS, and prints one JSON line.
 *
 *     capi_poisson <n> <mode> <config file> <x file>
 *
 * The mode's vector type must be double ('D') or float ('F').  Built and
 * run by chip_smoke.py (amgx_tpu_torch/ops/kernels.py:build_native).
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "amgx_tpu_torch_c.h"

static long g_lines = 0;

static void count_lines(const char *msg, int length) {
  for (int i = 0; i < length; ++i)
    if (msg[i] == '\n') ++g_lines;
}

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

#define CHECK(call)                                                      \
  do {                                                                   \
    AMGX_RC rc_ = (call);                                                \
    if (rc_ != AMGX_RC_OK) {                                             \
      printf("{\"error\": \"%s\", \"rc\": %d}\n", #call, (int)rc_);     \
      return 1;                                                          \
    }                                                                    \
  } while (0)

int main(int argc, char **argv) {
  if (argc != 5) {
    fprintf(stderr, "usage: %s <n> <mode> <config file> <x file>\n",
            argv[0]);
    return 2;
  }
  const int g = atoi(argv[1]);
  const char *mode = argv[2];
  const char vec_letter = strlen(mode) == 4 ? mode[1] : '?';
  if (g < 2 || (vec_letter != 'D' && vec_letter != 'F')) {
    fprintf(stderr, "capi_poisson: n >= 2 and a mode with D or F vectors\n");
    return 2;
  }
  const size_t vsz = vec_letter == 'D' ? sizeof(double) : sizeof(float);
  const int n = g * g * g;

  /* CSR: at most 7 entries a row, in increasing column order */
  int *rp = malloc(sizeof(int) * (size_t)(n + 1));
  int *ci = malloc(sizeof(int) * (size_t)n * 7);
  double *v = malloc(sizeof(double) * (size_t)n * 7);
  void *b = malloc(vsz * (size_t)n);
  void *x = malloc(vsz * (size_t)n);
  if (!rp || !ci || !v || !b || !x) return 3;
  int nnz = 0;
  const int sa = g * g, sb = g;
  for (int i = 0; i < n; ++i) {
    const int a = i / sa, bb = (i / sb) % g, c = i % g;
    rp[i] = nnz;
    if (a > 0) ci[nnz] = i - sa, v[nnz++] = -1.0;
    if (bb > 0) ci[nnz] = i - sb, v[nnz++] = -1.0;
    if (c > 0) ci[nnz] = i - 1, v[nnz++] = -1.0;
    ci[nnz] = i, v[nnz++] = 6.0;
    if (c < g - 1) ci[nnz] = i + 1, v[nnz++] = -1.0;
    if (bb < g - 1) ci[nnz] = i + sb, v[nnz++] = -1.0;
    if (a < g - 1) ci[nnz] = i + sa, v[nnz++] = -1.0;
  }
  rp[n] = nnz;
  /* the matrix values in the mode's matrix type: D or F */
  const char mat_letter = mode[2];
  void *mv = v;
  float *vf = NULL;
  if (mat_letter == 'F') {
    vf = malloc(sizeof(float) * (size_t)nnz);
    if (!vf) return 3;
    for (int k = 0; k < nnz; ++k) vf[k] = (float)v[k];
    mv = vf;
  } else if (mat_letter != 'D') {
    fprintf(stderr, "capi_poisson: a mode with a D or F matrix\n");
    return 2;
  }
  for (int i = 0; i < n; ++i) {
    if (vsz == sizeof(double)) {
      ((double *)b)[i] = 1.0;
      ((double *)x)[i] = 0.0;
    } else {
      ((float *)b)[i] = 1.0f;
      ((float *)x)[i] = 0.0f;
    }
  }

  AMGX_config_handle cfg;
  AMGX_resources_handle res;
  AMGX_matrix_handle A;
  AMGX_vector_handle vb, vx;
  AMGX_solver_handle slv;
  const double t0 = now();
  CHECK(AMGX_initialize());
  const double t_init = now() - t0;
  CHECK(AMGX_register_print_callback(count_lines));
  int major = 0, minor = 0;
  CHECK(AMGX_get_api_version(&major, &minor));
  CHECK(AMGX_config_create_from_file(&cfg, argv[3]));
  CHECK(AMGX_resources_create_simple(&res, cfg));
  CHECK(AMGX_matrix_create(&A, res, mode));
  CHECK(AMGX_vector_create(&vb, res, mode));
  CHECK(AMGX_vector_create(&vx, res, mode));
  CHECK(AMGX_solver_create(&slv, res, mode, cfg));
  const double t1 = now();
  CHECK(AMGX_matrix_upload_all(A, n, nnz, 1, 1, rp, ci, mv, NULL));
  CHECK(AMGX_vector_upload(vb, n, 1, b));
  CHECK(AMGX_vector_upload(vx, n, 1, x));
  const double t2 = now();
  CHECK(AMGX_solver_setup(slv, A));
  const double t3 = now();
  CHECK(AMGX_solver_solve(slv, vb, vx));
  const double t4 = now();
  AMGX_SOLVE_STATUS status;
  int iters = -1;
  CHECK(AMGX_solver_get_status(slv, &status));
  CHECK(AMGX_solver_get_iterations_number(slv, &iters));
  CHECK(AMGX_vector_download(vx, x));
  /* a handle that names no object */
  const AMGX_RC bad = AMGX_solver_setup((AMGX_solver_handle)987654321, A);

  double rr = 0.0, bb2 = 0.0;
  for (int i = 0; i < n; ++i) {
    double s = 0.0;
    for (int k = rp[i]; k < rp[i + 1]; ++k) {
      const double xv = vsz == sizeof(double) ? ((double *)x)[ci[k]]
                                              : (double)((float *)x)[ci[k]];
      s += v[k] * xv;
    }
    const double bi = vsz == sizeof(double) ? ((double *)b)[i]
                                            : (double)((float *)b)[i];
    rr += (bi - s) * (bi - s);
    bb2 += bi * bi;
  }
  FILE *f = fopen(argv[4], "wb");
  if (!f || fwrite(x, vsz, (size_t)n, f) != (size_t)n) {
    printf("{\"error\": \"cannot write %s\"}\n", argv[4]);
    return 1;
  }
  fclose(f);

  CHECK(AMGX_solver_destroy(slv));
  CHECK(AMGX_vector_destroy(vx));
  CHECK(AMGX_vector_destroy(vb));
  CHECK(AMGX_matrix_destroy(A));
  CHECK(AMGX_resources_destroy(res));
  CHECK(AMGX_config_destroy(cfg));
  CHECK(AMGX_finalize());
  printf("{\"n\": %d, \"rows\": %d, \"nnz\": %d, \"mode\": \"%s\", "
         "\"api_version\": [%d, %d], \"status\": %d, \"iterations\": %d, "
         "\"rel_residual\": %.17g, \"print_lines\": %ld, "
         "\"rc_bad_handle\": %d, \"initialize_s\": %.6f, "
         "\"upload_s\": %.6f, \"setup_s\": %.6f, \"solve_s\": %.6f}\n",
         g, n, nnz, mode, major, minor, (int)status, iters,
         sqrt(rr / bb2), g_lines, (int)bad, t_init, t2 - t1, t3 - t2,
         t4 - t3);
  free(rp);
  free(ci);
  free(v);
  free(vf);
  free(b);
  free(x);
  return 0;
}
